"""The PyTorch port stands alone: no jax, nothing of the reference package.

``src/repro_torch/**.py``, ``chip_smoke.py``,
``scripts/row_tiles_bench.py``, ``scripts/decode_drift.py``,
``scripts/train_aten_calls.py``, ``scripts/gloo_cuda_probe.py`` and
``scripts/profiler_probe.py`` (all run on a machine without jax) may
import torch, numpy, the standard library, ``repro_torch`` and
``chip_smoke`` -- never ``jax`` or ``repro``.
"""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_no_jax_or_reference_imports_in_the_port():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "scripts" / "row_tiles_bench.py",
              ROOT / "scripts" / "decode_drift.py",
              ROOT / "scripts" / "train_aten_calls.py",
              ROOT / "scripts" / "gloo_cuda_probe.py",
              ROOT / "scripts" / "profiler_probe.py"]
    assert len(files) > 20
    port = ROOT / "src" / "repro_torch"
    for sub in ("core", "core/bank", "designs", "kernels/bank_fold",
                "kernels/mcim_fold", "kernels/prefix_adder",
                "kernels/karatsuba_ppm", "kernels/int8_matmul", "quant",
                "optim", "verify", "autotune", "serving", "exact", "rng",
                "data", "configs", "models", "launch", "checkpoint",
                "runtime"):
        assert any(f.parent == port / sub for f in files), sub
    bad =[f"{f.relative_to(ROOT)}:{line}: {mod}"
           for f in files for line, mod in _imported_roots(f)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_and_reference_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch\n"
            "from repro_torch import designs\n"
            "from repro_torch.kernels import bank_fold, mcim_fold\n"
            "from repro_torch.kernels import int8_matmul, karatsuba_ppm, "
            "prefix_adder\n"
            "from repro_torch import quant\n"
            "from repro_torch.optim import compress\n"
            "import numpy as np\n"
            "import torch\n"
            "d = designs.generate('tp3p5_w32', device='cpu')\n"
            "assert d.mul(0xDEADBEEF, 0xCAFEBABE) == "
            "0xDEADBEEF * 0xCAFEBABE\n"
            "a = torch.tensor([[0xBEEF, 0xDEAD]], dtype=torch.int32)\n"
            "p = karatsuba_ppm.kara_mul(a, a)\n"
            "from repro_torch.core import limbs as L\n"
            "assert torch.equal(prefix_adder.fast_final_adder(L.ppm(a, a)), "
            "p)\n"
            "assert L.from_limbs(p[0]) == 0xDEADBEEF ** 2\n"
            "x = torch.eye(4)\n"
            "assert torch.equal(quant.quantized_matmul(x, x).float(), x)\n"
            "g = {'w': x}\n"
            "q, s, e = compress.compress_grads(g, compress.init_error(g))\n"
            "assert torch.equal(compress.decompress_grads(q, s, g)['w'], x)\n"
            "from repro_torch import autotune, serving, verify\n"
            "assert verify.verify_design(d) == ()\n"
            "f = autotune.search('tp3p5_w32', use_cache=False)\n"
            "assert f.best_meeting(3.5) is not None\n"
            "reqs = serving.synthesize(serving.poisson_arrivals(16, 2.0), "
            "32, 32, budget=64)\n"
            "rep, _ = d.serve(reqs, replicas=2, check=True)\n"
            "assert rep.bit_exact is True\n"
            "import dataclasses\n"
            "from repro_torch import data, exact, rng\n"
            "from repro_torch.core.bank import sharded_execute\n"
            "r = designs.generate(dataclasses.replace(d.spec, replicas=2), "
            "devices=['cpu', 'cpu'])\n"
            "aa = torch.cat([a, a])\n"
            "assert torch.equal(r.mul(aa, aa), d.mul(aa, aa))\n"
            "assert float(exact.exact_sum(torch.ones(3))) == 3.0\n"
            "assert rng.philox4x32(torch.zeros(1, 4, dtype=torch.long), "
            "torch.zeros(1, 2, dtype=torch.long))[0, 0] == 0x6627E8D5\n"
            "src = data.SyntheticLM(data.DataConfig(10, 4, 2), device='cpu')\n"
            "assert src.batch_at(0)['tokens'].shape == (2, 4)\n"
            "assert hasattr(compress, 'compressed_psum')\n"
            "from repro_torch.configs import get_config\n"
            "from repro_torch.launch import serve\n"
            "from repro_torch.models import build_model\n"
            "m = build_model(get_config('gemma3-1b', smoke=True), 'cpu')\n"
            "m.init(torch.Generator().manual_seed(0))\n"
            "eng = serve.ServeEngine(m, 2, 4, 12)\n"
            "serve.serve(eng, [np.arange(4)] * 3, 2)\n"
            "assert eng.arrival_trace() == (0, 0, 2)\n"
            "import tempfile\n"
            "from repro_torch import checkpoint, optim, runtime\n"
            "from repro_torch.launch import train as launch_train\n"
            "from repro_torch.optim import adafactor\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    res = launch_train.main(['--smoke', '--steps', '2', "
            "'--device', 'cpu', '--no-resume', '--checkpoint-dir', d])\n"
            "    assert checkpoint.CheckpointManager(d).latest_step() == 2\n"
            "assert res.final_step == 2 and res.skipped_steps == 0\n"
            "assert isinstance(optim.AdamWConfig(), optim.AdamWConfig)\n"
            "assert runtime.TrainerConfig().steps == 100\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m in sys.modules if sys.modules[m])\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
