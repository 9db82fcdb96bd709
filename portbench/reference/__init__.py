"""The plain reference that decides `correct`, in two parts.  The per-pixel
stages are rectdetect_tpu_torch's plain PyTorch path as it stood when the
benchmark was written (its modules config, core/, ops/ and the front of
pipeline/rect.py copied with their imports renamed), with every
hand-written kernel replaced by its plain form (ops/plain_kernels.py) and
no capacity.  Everything from the polylines on is upstream's semantics in
NumPy, written apart from the port (upstream/).  It imports nothing of the
port and runs on any device; frame.py is its entry.  The port's CPU path
agrees with it within the cells' limits
(portbench/tests/test_portbench_reference.py)."""
