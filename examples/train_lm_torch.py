"""Train a reduced qwen3-family LM for a few hundred steps with
checkpoint/restart on the PyTorch port (thin wrapper over its driver,
twin of ``examples/train_lm.py``). Runs on the card unless ``--device
cpu`` is given.

    PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]
"""
import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    device = ap.parse_args(argv).device
    ckpt = tempfile.mkdtemp(prefix="repro_torch_lm_")
    train_main(["--arch", "qwen3-0.6b", "--scale", "smoke",
                "--steps", "200", "--batch", "8", "--seq", "128",
                "--ckpt-dir", ckpt, "--ckpt-every", "50",
                "--log-every", "20", "--device", device])
    print(f"checkpoints in {ckpt}")


if __name__ == "__main__":
    main()
