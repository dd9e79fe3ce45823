"""The port's lint (``repro_torch.verify.lint``): every rule fires on a
seeded source, as ``tests/test_verify.py`` seeds the reference's; the
static attributes launder taint; the environment allow-list holds; and
the port's own tree lints clean."""
import pathlib

import pytest

from repro_torch.verify import lint

ROOT = pathlib.Path(__file__).resolve().parent.parent
ROUND = "src/repro_torch/kernels/seeded.py"       # on the round's path
MODEL = "src/repro_torch/models/seeded.py"        # outside it


def _rules(source, path=ROUND):
    return [v.rule for v in lint.lint_source(source, path)]


def test_lint_clean_on_the_port_tree():
    violations = lint.lint_tree(ROOT / "src" / "repro_torch")
    assert violations == [], "\n".join(v.describe() for v in violations)


@pytest.mark.parametrize("body", [
    "    if x.sum() > 0:\n        return x\n    return x\n",
    "    while (x > 0).any():\n        x = x - 1\n    return x\n",
    "    return x if x.max() else x + 1\n",
    "    assert (x >= 0).all()\n    return x\n",
    "    n = int(x[0])\n    return n\n",
    "    return float(x.sum())\n",
    "    return bool(x.any())\n",
    "    return x.sum().item()\n",
    "    return x.tolist()\n",
    "    y = x * 2\n    return y.cpu()\n",
    "    return (x + 1).numpy()\n",
])
def test_host_sync_fires_on_tensor_values(body):
    src = "import torch\ndef f(x: torch.Tensor, n: int):\n" + body
    assert _rules(src) == ["host-sync"]
    assert _rules(src, MODEL) == []          # the model path is outside


def test_host_sync_taint_flows_through_assignments():
    src = ("import torch\n"
           "def f(a: torch.Tensor):\n"
           "    b = a[1:]\n"
           "    c, d = b * 2, 3\n"
           "    if d > 2:\n"
           "        pass\n"
           "    if c.any():\n"
           "        pass\n")
    got = lint.lint_source(src, ROUND)
    assert [v.rule for v in got] == ["host-sync"]
    assert got[0].where.endswith(":7 in f")


def test_static_attributes_launder_taint():
    good = ("import torch\n"
            "from repro_torch.kernels import _row_tiles\n"
            "def f(x: torch.Tensor, acc: 'torch.Tensor'):\n"
            "    if x.ndim == 1 and x.dtype == torch.int32:\n"
            "        return x\n"
            "    if x.device.type == 'cpu' or x.numel() == 0:\n"
            "        return x\n"
            "    n = int(x.shape[0]) + len(x) + x.size(1)\n"
            "    if not x.is_contiguous() or x.data_ptr() % 16:\n"
            "        return x\n"
            "    if _row_tiles.is_aligned(x, acc) and n > 2:\n"
            "        return x\n"
            "    acc = x if acc is None else acc + x\n"
            "    return acc\n")
    assert lint.lint_source(good, ROUND) == []


def test_host_sync_covers_compiled_design_mul_only():
    src = ("import torch\n"
           "class CompiledDesign:\n"
           "    def mul(self, a: torch.Tensor, b: torch.Tensor):\n"
           "        return a.tolist()\n"
           "    def report(self, a: torch.Tensor):\n"
           "        return a.tolist()\n")
    got = lint.lint_source(src, "src/repro_torch/designs/compile.py")
    assert [(v.rule, v.where.split(" in ")[1]) for v in got] == [
        ("host-sync", "mul")]
    assert lint.lint_source(src, "src/repro_torch/designs/spec.py") == []


def test_scheduler_state_fires():
    bad = ("class CountingScheduler:\n"
           "    def schedule(self, cts, n_ops):\n"
           "        self.calls = getattr(self, 'calls', 0) + 1\n"
           "        return ((), 0)\n")
    assert _rules(bad, MODEL) == ["scheduler-state"]


@pytest.mark.parametrize("read", [
    "os.environ['CUDA_VISIBLE_DEVICES']",
    "os.environ.get('REPRO_TORCH_PATH', 'bulk')",
    "os.getenv('REPRO_TORCH_DEVICE')",
    "dict(environ)",
])
def test_env_read_fires_outside_the_allow_list(read):
    src = f"import os\nfrom os import environ\nx = {read}\n"
    assert _rules(src, MODEL) == ["env-read"]
    for allowed in lint.ENV_ALLOWED:
        assert _rules(src, f"src/repro_torch/{allowed}") == []


def test_env_allow_list_is_the_stated_one(monkeypatch):
    """With the allow-list emptied, the port's only environment readers
    are the modules it names."""
    assert set(lint.ENV_ALLOWED) == {"runtime/trainer.py",
                                     "autotune/cache.py"}
    monkeypatch.setattr(lint, "ENV_ALLOWED", {})
    port = ROOT / "src" / "repro_torch"
    readers = {v.where.split(":")[0] for v in lint.lint_tree(port)
               if v.rule == "env-read"}
    assert readers == {str(port / path) for path in
                       ("runtime/trainer.py", "autotune/cache.py")}


@pytest.mark.parametrize("src", [
    # a failed kernel falls back to the plain version
    "def f(a, b):\n"
    "    try:\n"
    "        return kernel(a, b)\n"
    "    except RuntimeError:\n"
    "        return fused_bank_mul_ref(a, b)\n",
    # a failed launch is swallowed
    "def f(fn, t):\n"
    "    try:\n"
    "        _build.launch('bank_fold', fn, t, (1,))\n"
    "    except RuntimeError:\n"
    "        pass\n",
    "def f():\n"
    "    try:\n"
    "        fn = _build.launcher('bank_fold', 'x', 4, 5)\n"
    "    except AttributeError as e:\n"
    "        print(e)\n",
])
def test_cuda_fallback_fires(src):
    assert _rules(src, MODEL) == ["cuda-fallback"]


def test_a_handler_that_raises_is_no_fallback():
    src = ("def f(fn, t):\n"
           "    try:\n"
           "        _build.launch('bank_fold', fn, t, (1,))\n"
           "    except RuntimeError as e:\n"
           "        raise ValueError('launch failed') from e\n"
           "    try:\n"
           "        return compute()\n"
           "    except KeyError:\n"
           "        return None\n")
    assert _rules(src, MODEL) == []


@pytest.mark.parametrize("stmt", ["import jax", "import jax.numpy as jnp",
                                  "from jaxlib import xla_client",
                                  "from repro.core import limbs",
                                  "import repro.verify"])
def test_foreign_import_fires(stmt):
    assert _rules(stmt + "\n", MODEL) == ["foreign-import"]
    assert _rules("from . import repro_helpers\nimport repro_torch\n",
                  MODEL) == []


def test_syntax_error_is_a_finding():
    assert _rules("def f(:\n", MODEL) == ["syntax-error"]
