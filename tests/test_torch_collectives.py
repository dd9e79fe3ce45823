"""The port's collectives, ``exact.exact_psum`` and
``optim.compress.compressed_psum``, in a 4-rank ``gloo`` world on the CPU,
bit for bit against the JAX reference under ``shard_map`` on a 4-device
placeholder mesh (the inputs of ``tests/test_distributed_features.py``,
plus a second error-feedback step, a 1-D leaf and an all-zero leaf).

Both sides run in subprocesses: the reference because its device count
must be set before jax is imported, the ranks because each is a process
of its own.  They meet through ``.npz`` files in ``tmp_path``; the world
rendezvous through a ``FileStore`` there, and every process has a time
limit that fails the test instead of hanging it.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")
WORLD = 4
LIMIT_S = 120

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.exact import exact_psum
from repro.optim.compress import compressed_psum, init_error

inp, out = sys.argv[1], sys.argv[2]
d = {k: jnp.asarray(v) for k, v in np.load(inp).items()}
mesh = jax.make_mesh((4,), ("data",))


def exact(xs):
    return exact_psum(xs[0], "data")


def run_exact(x):
    return np.asarray(shard_map(exact, mesh=mesh, in_specs=P("data", None),
                                out_specs=P(), check_vma=False)(x))


def step(tree, err):
    grads = {k: v[0] for k, v in tree.items()}
    err = {k: v[0] for k, v in err.items()}
    avg, new_err = compressed_psum(grads, err, "data")
    return avg, {k: v[None] for k, v in new_err.items()}


def run_step(tree, err):
    spec = {k: P("data") for k in tree}
    return shard_map(step, mesh=mesh, in_specs=(spec, spec),
                     out_specs=({k: P() for k in tree}, spec),
                     check_vma=False)(tree, err)


res = {"exact": run_exact(d["x"]),
       "exact_rolled": run_exact(jnp.roll(d["x"], 1, axis=0))}
tree = {"g": d["g"], "b": d["b"], "z": d["z"]}
zero = {k: jnp.zeros_like(v) for k, v in tree.items()}
avg, err = run_step(tree, zero)
tree2 = {"g": d["g2"], "b": d["b2"], "z": d["z"]}
avg2, err2 = run_step(tree2, err)
for k in tree:
    res[f"avg_{k}"], res[f"err_{k}"] = np.asarray(avg[k]), np.asarray(err[k])
    res[f"avg2_{k}"], res[f"err2_{k}"] = (np.asarray(avg2[k]),
                                          np.asarray(err2[k]))
np.savez(out, **res)
"""

RANK = r"""
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.exact import exact_psum
from repro_torch.optim.compress import compressed_psum, init_error

rank, world = int(sys.argv[1]), int(sys.argv[2])
store, inp, out = sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
d = {k: torch.from_numpy(v) for k, v in np.load(inp).items()}
res = {"exact": exact_psum(d["x"][rank]),
       "exact_rolled": exact_psum(d["x"][(rank - 1) % world])}
tree = {k: d[k][rank] for k in ("g", "b", "z")}
avg, err = compressed_psum(tree, init_error(tree))
tree2 = {"g": d["g2"][rank], "b": d["b2"][rank], "z": d["z"][rank]}
avg2, err2 = compressed_psum(tree2, err)
for k in tree:
    res[f"avg_{k}"], res[f"err_{k}"] = avg[k], err[k]
    res[f"avg2_{k}"], res[f"err2_{k}"] = avg2[k], err2[k]
dist.destroy_process_group()
np.savez(out, **{k: v.numpy() for k, v in res.items()})
"""


def _env():
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")


def _inputs(path):
    x = np.random.default_rng(0).standard_normal((WORLD, 16)).astype(
        np.float32)
    g = np.random.default_rng(1).standard_normal((WORLD, 8, 32)).astype(
        np.float32)
    rng = np.random.default_rng(2)
    np.savez(path, x=x, g=g,
             g2=rng.standard_normal((WORLD, 8, 32)).astype(np.float32),
             b=rng.standard_normal((WORLD, 32)).astype(np.float32),
             b2=rng.standard_normal((WORLD, 32)).astype(np.float32),
             z=np.zeros((WORLD, 4, 32), np.float32))


def _finish(procs):
    """Wait for every process within the time limit; kill them all and
    fail on a timeout or a non-zero exit."""
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=LIMIT_S)
            if p.returncode:
                errors.append(err[-3000:])
    except subprocess.TimeoutExpired:
        errors.append(f"a process passed its {LIMIT_S} s limit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errors, errors


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inp = tmp / "inputs.npz"
    _inputs(inp)
    procs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(inp), str(tmp / "ref.npz")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(WORLD), str(tmp / "store"),
         str(inp), str(tmp / f"rank{r}.npz")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    _finish(procs)
    return (dict(np.load(tmp / "ref.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
            dict(np.load(inp)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("key", ("exact", "exact_rolled"))
def test_exact_psum_matches_reference_on_every_rank(results, key):
    ref, ranks, _ = results
    for got in ranks:
        np.testing.assert_array_equal(_bits(got[key]), _bits(ref[key]))


def test_exact_psum_is_permutation_invariant(results):
    ref, ranks, inputs = results
    for got in ranks:
        np.testing.assert_array_equal(_bits(got["exact"]),
                                      _bits(got["exact_rolled"]))
    want = np.sum(inputs["x"].astype(np.float64), axis=0)
    np.testing.assert_allclose(ranks[0]["exact"], want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("leaf", ("g", "b", "z"))
@pytest.mark.parametrize("step", ("", "2"))
def test_compressed_psum_matches_reference(results, step, leaf):
    """The mean on every rank and each rank's error buffer (the
    reference's error comes back stacked over the mesh axis)."""
    ref, ranks, _ = results
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(_bits(got[f"avg{step}_{leaf}"]),
                                      _bits(ref[f"avg{step}_{leaf}"]))
        np.testing.assert_array_equal(_bits(got[f"err{step}_{leaf}"]),
                                      _bits(ref[f"err{step}_{leaf}"][rank]))


def test_compressed_psum_accuracy_as_the_reference_gates_it(results):
    _, ranks, inputs = results
    true_avg = np.mean(inputs["g"].astype(np.float64), axis=0)
    avg = ranks[0]["avg_g"]
    rel = np.linalg.norm(avg - true_avg) / np.linalg.norm(true_avg)
    assert rel < 0.05, rel
    assert np.abs(ranks[0]["err_g"]).max() > 0       # residual captured
    assert not ranks[0]["avg_z"].any() and not ranks[0]["err_z"].any()
