"""Entry of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the card(s) the cell
asks for. Host thread pools are fixed to one thread before NumPy and
PyTorch load, so the host's shared cores are not oversubscribed, and
the port's tuning cache is switched off so the configuration's knobs
and the built-in kernel parameters are what runs.
"""
import os
import sys
import time

T_START = time.perf_counter()
HOST_THREADS = "1"
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = HOST_THREADS
os.environ["REPRO_TORCH_TUNING_DISABLE"] = "1"
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]

if __name__ == "__main__":
    import torch

    torch.set_num_threads(int(HOST_THREADS))
    torch.set_num_interop_threads(int(HOST_THREADS))
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
