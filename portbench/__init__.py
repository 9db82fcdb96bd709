"""The benchmark of rectdetect_tpu_torch, the PyTorch and CUDA port, on one
H100 a cell: `python -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout.  BENCHMARK.json
at the root names the cells; everything a cell needs is found by name
under this folder: configs/<config>.json, traffic/<traffic>.json,
drivers/<driver>.py and metrics/<metric>.py.  The plain reference that
decides `correct` is reference/, which imports nothing of the port."""
