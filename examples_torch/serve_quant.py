"""Batched serving example: continuous batching over prefill/decode.

  PYTHONPATH=src python examples_torch/serve_quant.py [--device cpu]
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    eng = serve_main(["--arch", "gemma3-1b", "--smoke",
                      "--requests", "6", "--slots", "2",
                      "--prompt-len", "16", "--max-new", "8",
                      "--device", str(device)])
    assert len(eng.outputs) == 6
    assert all(len(toks) >= 8 for toks in eng.outputs.values())
    assert len(eng.arrival_trace()) == 6
    return eng


if __name__ == "__main__":
    main()
