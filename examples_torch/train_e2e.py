"""End-to-end training run: a ~100M-class qwen3-family model on the
learnable pattern stream, with checkpoint/resume and the MCIM exact
accumulation path. Smoke-sized by default; flags scale it up.

  PYTHONPATH=src python examples_torch/train_e2e.py [--steps 60]
      [--preset-100m] [--checkpoint-dir DIR] [--device cpu]

It resumes from the latest checkpoint in ``--checkpoint-dir``
(``$TMPDIR/repro_torch_e2e_ckpt`` by default).
"""
import argparse
import os
import tempfile

from repro_torch.device import resolve_device
from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--preset-100m", action="store_true",
                    help="full ~100M preset")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_e2e_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    argv = ["--arch", "qwen3-32b", "--steps", str(args.steps),
            "--seq-len", "128", "--global-batch", "8",
            "--source", "pattern", "--microbatches", "2", "--exact-accum",
            "--checkpoint-dir", args.checkpoint_dir,
            "--device", str(device)]
    argv += (["--preset", "100m"] if args.preset_100m else ["--smoke"])
    res = train_main(argv)
    assert res.losses[-1] < res.losses[0], "training must reduce loss"
    return res


if __name__ == "__main__":
    main()
