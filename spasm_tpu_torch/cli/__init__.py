"""Command-line tools mirroring the reference's tools/ directory (ports
of spasm_tpu/cli/):

  python -m spasm_tpu_torch.cli.rank          rank (tools/rank.c)
  python -m spasm_tpu_torch.cli.echelonize    U / RREF output (tools/echelonize.c)
  python -m spasm_tpu_torch.cli.kernel        kernel basis (tools/kernel.c)
  python -m spasm_tpu_torch.cli.solve         XA == B (tools/solve.c)
  python -m spasm_tpu_torch.cli.dm            Dulmage-Mendelsohn (tools/dm.c)
  python -m spasm_tpu_torch.cli.check_cert    verify rank certificate
  python -m spasm_tpu_torch.cli.stack         drop empty rows/cols (tools/stack.c)
  python -m spasm_tpu_torch.cli.vertical_swap mirror columns
  python -m spasm_tpu_torch.cli.transpose     transpose filter
  python -m spasm_tpu_torch.cli.bitmap        PBM/PGM density image

All tools are Unix filters: SMS/MatrixMarket on stdin (or --matrix FILE),
result on stdout, logs on stderr — same conventions as the reference.
rank, echelonize, kernel and solve echelonize on the card (there is no
--device flag); the others run on the host.
"""
