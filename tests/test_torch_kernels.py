"""The port's kernels (bank_fold #1; mcim_fold fb #2, ff #3, karatsuba #4;
prefix_adder #5, karatsuba_ppm #6, int8_matmul #7).

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX reference's Pallas kernels in interpret mode
(``repro.kernels.mcim_fold.mcim_fold_mul`` / ``repro.kernels.bank_fold.
fused_bank_mul``) on the same numpy operands, with integer equality
(tolerance 0) and the Python-bigint oracle.

Tests marked ``cuda`` hold each hand-written CUDA kernel against its
plain version on the card, bit for bit (bf16 outputs compared as bits);
they skip without a card.  The CPU parity tests of #5-#7 are in
``test_torch_prefix_adder.py``, ``test_torch_karatsuba_ppm.py`` and
``test_torch_quant.py``.  The
JAX reference is imported inside the CPU tests only, so that
``pytest -m cuda`` runs this file on a machine without jax.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import limbs as TL
from repro_torch.core import planner as TP
from repro_torch.kernels import _build
from repro_torch.kernels import bank_fold as TB
from repro_torch.kernels import int8_matmul as TI
from repro_torch.kernels import karatsuba_ppm as TK
from repro_torch.kernels import mcim_fold as TF
from repro_torch.kernels import prefix_adder as TPA

FOLDS = [("fb", 1), ("fb", 2), ("fb", 3), ("fb", 12), ("ff", 2), ("ff", 4),
         ("karatsuba", 3)]


def _pair(seed, shape, bits_a, bits_b=None):
    """Operands as numpy uint32 limbs (the reference's random stream)."""
    rng = np.random.default_rng(seed)
    return (TL.random_limbs(rng, shape, bits_a),
            TL.random_limbs(rng, shape, bits_b or bits_a))


def _products(a, b):
    return [TL.from_limbs(x) * TL.from_limbs(y)
            for x, y in zip(a.reshape(-1, a.shape[-1]),
                            b.reshape(-1, b.shape[-1]))]


@pytest.fixture
def ref():
    """The JAX reference's modules (imported here, not at module level)."""
    import jax.numpy as jnp
    from repro.core import planner
    from repro.kernels import bank_fold, mcim_fold
    return types.SimpleNamespace(jnp=jnp, planner=planner,
                                 bank_fold=bank_fold, mcim_fold=mcim_fold)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there (the CPU path is their plain version)")
    return torch.device("cuda")


# ----------------------------------------------- mcim_fold (kernels #2-#4)

@pytest.mark.parametrize("bits", (32, 128, 256))
@pytest.mark.parametrize("schedule,ct", FOLDS)
def test_big_mul_plain_matches_reference_kernel(schedule, ct, bits, ref):
    a, b = _pair(bits + ct, (24,), bits)
    want = ref.mcim_fold.mcim_fold_mul(
        ref.jnp.asarray(a), ref.jnp.asarray(b), ct=ct, schedule=schedule,
        tile_b=8, interpret=True)
    before = _build.launch_counts()
    port = TF.big_mul(TL.from_numpy(a, "cpu"), TL.from_numpy(b, "cpu"),
                      ct=ct, schedule=schedule)
    assert _build.launch_counts() == before      # CPU: no kernel launch
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(want).astype(np.int32))
    assert TL.batch_from_limbs(port) == _products(a, b)


def test_big_mul_mixed_widths_and_single_row():
    a, b = _pair(5, (9,), 48, 80)
    for schedule, ct in FOLDS:
        port = TF.big_mul(TL.from_numpy(a, "cpu"), TL.from_numpy(b, "cpu"),
                          ct=ct, schedule=schedule)
        assert TL.batch_from_limbs(port) == _products(a, b)
        one = TF.big_mul(TL.from_numpy(a[0], "cpu"),
                         TL.from_numpy(b[0], "cpu"), ct=ct,
                         schedule=schedule)
        assert one.shape == (a.shape[-1] + b.shape[-1],)
        assert TL.from_limbs(one) == _products(a, b)[0]


def test_mcim_fold_schedule_errors():
    x = TL.from_numpy(np.ones((2, 2), np.uint32), "cpu")
    with pytest.raises(ValueError):
        TF.mcim_fold_mul(x, x, schedule="nope")
    with pytest.raises(ValueError):
        TF.mcim_fold_mul(x, x, ct=2, schedule="karatsuba")
    with pytest.raises(ValueError):
        TF.mcim_fold_mul(x, x, ct=1, schedule="ff")


@pytest.mark.parametrize("la,lb,ct,schedule", [
    (2, 2, 2, "fb"), (4, 9, 3, "ff"), (1, 10, 3, "fb"), (5, 3, 3,
                                                          "karatsuba")])
def test_fold_geometry_matches_reference(la, lb, ct, schedule, ref):
    want = ref.mcim_fold.fold_geometry(la, lb, ct, schedule)
    port = TF.fold_geometry(la, lb, ct, schedule)
    assert port.b_windows == want.b_windows
    for field in ("chunk", "ct_run", "scratch_width", "out_width"):
        assert getattr(port, field) == getattr(want, field)
    for tile in (8, 256):
        assert TF.vmem_bytes_per_step(la, lb, ct, tile, schedule) == \
            ref.mcim_fold.vmem_bytes_per_step(la, lb, ct, tile, schedule)


@pytest.mark.parametrize("bsz", (1, 7, 55, 56, 97, 256, 1000, 1031))
def test_batch_tile_matches_reference(bsz, ref):
    assert TF.batch_tile(bsz) == ref.mcim_fold.batch_tile(bsz)


# ------------------------------------------------------- bank_fold (#1)

@pytest.mark.parametrize("bits,tp", [(32, "7/2"), (128, "5/6"),
                                     (64, "1/2")])
def test_fused_plain_matches_reference_kernel(bits, tp, ref):
    """Super-geometries with idle steps (tp3p5_w32: star + fb2;
    tp5over6_w128: fb2 + karatsuba) through the plain windowed schoolbook
    and the reference's Pallas kernel."""
    ref_plan = ref.planner.plan_throughput(bits, bits, tp)
    port_plan = TP.plan_throughput(bits, bits, tp)
    ref_cfgs = [c for n, c in ref_plan.configs for _ in range(n)]
    port_cfgs = [c for n, c in port_plan.configs for _ in range(n)]
    la = TL.n_limbs_for_bits(bits)
    ref_sg = ref.bank_fold.super_geometry(ref_cfgs, la, la)
    port_sg = TB.super_geometry(port_cfgs, la, la)
    np.testing.assert_array_equal(port_sg.table(), ref_sg.table())
    a, b = _pair(bits, (port_sg.n_instances, 16), bits)
    want = ref.bank_fold.fused_bank_mul(
        ref.jnp.asarray(a), ref.jnp.asarray(b),
        ref.jnp.asarray(ref_sg.table()), max_steps=ref_sg.max_steps,
        tile_r=8, interpret=True)
    before = _build.launch_counts()
    port = TB.fused_bank_mul(TL.from_numpy(a, "cpu"),
                             TL.from_numpy(b, "cpu"),
                             torch.from_numpy(port_sg.table()))
    assert _build.launch_counts() == before
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(want).astype(np.int32))
    assert TL.batch_from_limbs(port) == _products(a, b)


def test_fused_idle_and_partial_windows():
    """A hand-made table: idle (0,0) steps add nothing; a partial window
    multiplies only its limbs."""
    a, b = _pair(3, (2, 5), 64)
    table = torch.tensor([[[0, 4], [0, 0], [0, 0]],
                          [[2, 4], [0, 0], [0, 1]]], dtype=torch.int32)
    out = TB.fused_bank_mul(TL.from_numpy(a, "cpu"),
                            TL.from_numpy(b, "cpu"), table)
    full, part = out[0], out[1]
    assert TL.batch_from_limbs(full) == _products(a[0], b[0])
    b_part = b[1].copy()
    b_part[:, 1] = 0                 # limb 1 lies in no window
    assert TL.batch_from_limbs(part) == _products(a[1], b_part)


def test_fused_block_rows_match_reference(ref):
    for assign in (((0, 1, 2), (3,)), ((),), tuple((i,) for i in range(9)),
                   (tuple(range(57)), tuple(range(57, 70)))):
        assert TB.fused_block_rows(assign) == \
            ref.bank_fold.fused_block_rows(assign)


def test_fused_shape_errors():
    x = TL.from_numpy(np.ones((2, 3, 2), np.uint32), "cpu")
    with pytest.raises(ValueError):
        TB.fused_bank_mul(x, x[:1],
                          torch.zeros((2, 1, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        TB.fused_bank_mul(x, x, torch.zeros((3, 1, 2), dtype=torch.int32))


def test_kernel_operand_checks():
    with pytest.raises(ValueError):       # one limb past the widest
        _build.check_limbs("k", _build.MAX_LIMBS + 1, 2)
    _build.check_limbs("k", _build.MAX_LIMBS, _build.MAX_LIMBS)
    with pytest.raises(ValueError):      # a CPU tensor is not a CUDA one
        _build.check_cuda_operands("k", torch.zeros(2, dtype=torch.int32))


# --------------------------------------------------- on the card (cuda)

@pytest.mark.cuda
@pytest.mark.parametrize("bits", (8, 32, 64, 128, 200, 256))
@pytest.mark.parametrize("schedule,ct", FOLDS)
def test_fold_kernel_matches_plain_on_card(cuda_device, schedule, ct, bits):
    a, b = _pair(bits * ct, (1000,), bits)
    a, b = TL.from_numpy(a, cuda_device), TL.from_numpy(b, cuda_device)
    name = f"mcim_fold_{schedule}"
    before = _build.launch_counts()[name]
    got = TF.mcim_fold_mul(a, b, ct=ct, schedule=schedule)
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 1
    want = TF.mcim_fold_mul_ref(a, b, ct=ct, schedule=schedule)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,tp", [(32, "7/2"), (128, "5/6"), (256, "1/3"),
                                     (16, "11/12")])
def test_bank_kernel_matches_plain_on_card(cuda_device, bits, tp):
    plan = TP.plan_throughput(bits, bits, tp)
    cfgs = [c for n, c in plan.configs for _ in range(n)]
    la = TL.n_limbs_for_bits(bits)
    sg = TB.super_geometry(cfgs, la, la)
    a, b = _pair(bits, (sg.n_instances, 777), bits)
    a, b = TL.from_numpy(a, cuda_device), TL.from_numpy(b, cuda_device)
    table = torch.from_numpy(sg.table()).to(cuda_device)
    before = _build.launch_counts()["bank_fold"]
    got = TB.fused_bank_mul(a, b, table)
    torch.cuda.synchronize()
    assert _build.launch_counts()["bank_fold"] == before + 1
    assert torch.equal(got.cpu(), TB.fused_bank_mul(a.cpu(), b.cpu(),
                                                    table.cpu()))


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    wide = torch.zeros((4, _build.MAX_LIMBS + 1), dtype=torch.int32,
                       device=cuda_device)           # one limb past the widest
    with pytest.raises(ValueError):
        TF.mcim_fold_mul(wide, wide, ct=2)
    small = torch.zeros((4, 2), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        TF.mcim_fold_mul(small, small, ct=2)
    mixed = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        TF.mcim_fold_mul(mixed.to(cuda_device), mixed, ct=2)


def _counted(name, fn, *args, **kwargs):
    """Run ``fn`` on the card and assert it launched ``name`` once."""
    before = _build.launch_counts()[name]
    got = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("width", (1, 2, 4, 16, 17, 32, 33, 64))
def test_prefix_adder_kernel_matches_plain_on_card(cuda_device, width):
    rng = np.random.default_rng(width)
    cols = rng.integers(0, 2**32 - 2**16, (1000, width), dtype=np.int64)
    cols[:7] = TL.MASK                   # full-width ripples
    cols[:7, 0] += 1
    cols = torch.from_numpy(cols).to(cuda_device)
    got = _counted("prefix_adder", TPA.fast_final_adder, cols)
    assert torch.equal(got, TPA.prefix_final_adder_ref(cols))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", (128, 256))
def test_prefix_adder_kernel_on_ppm_columns(cuda_device, bits):
    a, b = _pair(bits, (999,), bits)
    a, b = TL.from_numpy(a, cuda_device), TL.from_numpy(b, cuda_device)
    got = _counted("prefix_adder", TPA.fast_final_adder, TL.ppm(a, b))
    assert TL.batch_from_limbs(got) == _products(a.cpu().numpy(),
                                                 b.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", (2, 4, 6, 8, 10, 12, 14, 16))
def test_karatsuba_ppm_kernel_matches_plain_on_card(cuda_device, n):
    a, b = _pair(n, (1000,), 16 * n)
    a[:3], b[:3] = TL.MASK, TL.MASK      # all-ones operands
    a, b = TL.from_numpy(a, cuda_device), TL.from_numpy(b, cuda_device)
    got = _counted("karatsuba_ppm", TK.kara_mul, a, b)
    assert torch.equal(got, TK.karatsuba_ppm_mul_ref(a, b))
    assert TL.batch_from_limbs(got[:64]) == _products(
        a[:64].cpu().numpy(), b[:64].cpu().numpy())


def _int8_operands(m, k, n, device):
    rng = np.random.default_rng(m * k + n)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    sx = torch.from_numpy(rng.random(m, dtype=np.float32) + 0.01)
    sw = torch.from_numpy(rng.random(n, dtype=np.float32) + 0.01)
    return [t.to(device) for t in (x, w, sx, sw)]


def _same_bits(got, want, out_dtype):
    assert got.dtype == want.dtype == out_dtype
    bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    return torch.equal(got.view(bits), want.view(bits))


# mma.sync: (33, 70, 45), (1, 1, 1), (128, 4096, 130), (300, 129, 257);
# wgmma decode tiles: (64, 64, 64), gemma2-9b's decode batch; wgmma
# prefill tiles: (2048, 3584, 512), gemma2-9b's prefill chunk, K = 3600
# (not a multiple of the 128-deep stage), ragged M and N edges
# (100, 512, 208), (1152, 128, 4096)
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (33, 70, 45), (1, 1, 1),
                                   (128, 4096, 130), (300, 129, 257),
                                   (2048, 3584, 512), (64, 3584, 14336),
                                   (2048, 3584, 14336), (256, 3600, 256),
                                   (100, 512, 208), (1152, 128, 4096)])
@pytest.mark.parametrize("out_dtype", (torch.bfloat16, torch.float32))
def test_int8_matmul_kernel_matches_plain_on_card(cuda_device, m, k, n,
                                                  out_dtype):
    args = _int8_operands(m, k, n, cuda_device)
    got = _counted("int8_matmul", TI.int8_matmul, *args,
                   out_dtype=out_dtype)
    want = TI.int8_matmul_ref(*args, out_dtype=out_dtype)
    assert _same_bits(got, want, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("path", TI.PATHS)
@pytest.mark.parametrize("m,k,n", [(200, 640, 4096), (1, 3600, 48)])
@pytest.mark.parametrize("out_dtype", (torch.bfloat16, torch.float32))
def test_int8_each_kernel_path_matches_plain_on_card(cuda_device, path, m,
                                                     k, n, out_dtype):
    args = _int8_operands(m, k, n, cuda_device)
    got = _counted("int8_matmul", TI.int8_matmul_kernel, *args, path=path,
                   out_dtype=out_dtype)
    want = TI.int8_matmul_ref(*args, out_dtype=out_dtype)
    assert _same_bits(got, want, out_dtype)


@pytest.mark.cuda
def test_quantized_matmul_launches_the_kernel_on_card(cuda_device):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((96, 200), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((200, 72), dtype=np.float32))
    x, w = x.to(cuda_device), w.to(cuda_device)
    got = _counted("int8_matmul", TI.quantized_matmul, x, w)
    want = TI.quantized_matmul(x, w, use_kernel=False)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    cpu = TI.quantized_matmul(x.cpu(), w.cpu())
    assert torch.equal(got.cpu().view(torch.int16), cpu.view(torch.int16))


@pytest.mark.cuda
def test_new_kernels_refuse_what_they_do_not_take(cuda_device):
    wide = torch.zeros((4, 65), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        TPA.prefix_final_adder(wide)
    with pytest.raises(ValueError):                 # int32 columns
        TPA.prefix_final_adder(wide[:, :8].to(torch.int32))
    limbs = torch.zeros((4, _build.MAX_LIMBS + 2), dtype=torch.int32,
                        device=cuda_device)          # even, past the widest
    with pytest.raises(ValueError):
        TK.karatsuba_ppm_mul(limbs, limbs)
    x = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    s = torch.ones(4, device=cuda_device)
    with pytest.raises(ValueError):                 # not int8
        TI.int8_matmul(x, x.T.contiguous(), s, torch.ones(4, device=
                                                          cuda_device))


# ------------- bank_fold and FF on both paths of csrc/row_tiles.cuh (cuda)

# row counts around the tiles (128 rows; 256 bulk rows at 4 limbs, 512 at
# 2), and the main path's 300,032 rows
PATH_ROWS = (1, 7, 127, 128, 129, 255, 257, 511, 513, 300_032)
PATH_WIDTHS = ((2, 2), (4, 4), (8, 8), (16, 16), (3, 5))


def _on_card(x, device, offset=0):
    """numpy limbs as a contiguous CUDA view ``offset`` words into its
    storage (offset 1: 4-byte aligned, not 16)."""
    flat = torch.zeros(x.size + offset, dtype=torch.int32, device=device)
    flat[offset:] = TL.from_numpy(x.reshape(-1), device)
    return flat[offset:].view(x.shape)


def _bank_operands(n_inst, rows, la, lb, device, offset=0):
    """A round of n_inst x R random (LA, LB) rows in batch order, R a
    instance, their owners shuffled (a warp's rows mix instances), and a
    table whose instance i folds B over i + 1 windows, with idle (0, 0)
    steps (first for odd instances, last for even ones)."""
    a, b = _pair(n_inst * rows + la * lb, (n_inst * rows,), 16 * la,
                 16 * lb)
    max_steps = n_inst + 1
    table = np.zeros((n_inst, max_steps, 2), np.int32)
    for i in range(n_inst):
        chunk = -(-lb // (i + 1))
        wins = [(lo, min(lo + chunk, lb)) for lo in range(0, lb, chunk)]
        idle = [(0, 0)] * (max_steps - len(wins))
        table[i] = idle + wins if i % 2 else wins + idle
    owner = np.random.default_rng(rows).permutation(
        np.repeat(np.arange(n_inst, dtype=np.int32), rows))
    return (_on_card(a, device, offset), _on_card(b, device, offset),
            torch.from_numpy(owner).to(device),
            torch.from_numpy(table).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("path", TB.PATHS)
@pytest.mark.parametrize("rows", PATH_ROWS)
@pytest.mark.parametrize("la,lb", PATH_WIDTHS)
def test_bank_kernel_paths_match_plain_on_card(cuda_device, la, lb, rows,
                                               path):
    n_inst = 1 + PATH_ROWS.index(rows) % 4
    a, b, owner, table = _bank_operands(n_inst, rows, la, lb, cuda_device)
    before = _build.path_counts()["bank_fold"][path]
    if path == "bulk" and TB.launch_plan(n_inst, n_inst * rows, la, lb,
                                         True) != "bulk":
        with pytest.raises(ValueError, match="bulk"):
            TB.fused_bank_mul_kernel(a, b, owner, table, path=path)
        return
    got = _counted("bank_fold", TB.fused_bank_mul_kernel, a, b, owner,
                   table, path=path)
    assert torch.equal(got, TB.fused_bank_mul_ref(a, b, owner, table))
    assert _build.path_counts()["bank_fold"][path] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("path", TB.PATHS)
@pytest.mark.parametrize("la,lb", ((2, 2), (8, 8), (3, 5)))
def test_bank_kernel_paths_take_many_windows(cuda_device, la, lb, path):
    """40 windows an instance: the warps read the table 32 words at a
    time, so this crosses a load (and idle steps sit between windows)."""
    rng = np.random.default_rng(la * 100 + lb)
    n_inst, rows, steps = 3, 1000, 40
    a, b = _pair(7, (n_inst * rows,), 16 * la, 16 * lb)
    lo = rng.integers(0, lb + 1, size=(n_inst, steps))
    hi = lo + rng.integers(0, lb + 1, size=(n_inst, steps))
    table = np.stack([lo, np.minimum(hi, lb)], axis=-1).astype(np.int32)
    table[:, ::3] = 0                                  # idle steps
    owner = rng.integers(0, n_inst, n_inst * rows).astype(np.int32)
    a, b = TL.from_numpy(a, cuda_device), TL.from_numpy(b, cuda_device)
    owner = torch.from_numpy(owner).to(cuda_device)
    table = torch.from_numpy(table).to(cuda_device)
    if path == "bulk" and TB.launch_plan(n_inst, n_inst * rows, la, lb,
                                         True) != "bulk":
        return
    got = _counted("bank_fold", TB.fused_bank_mul_kernel, a, b, owner,
                   table, path=path)
    assert torch.equal(got, TB.fused_bank_mul_ref(a, b, owner, table))


@pytest.mark.cuda
@pytest.mark.parametrize("path", TF.PATHS)
@pytest.mark.parametrize("rows", PATH_ROWS)
@pytest.mark.parametrize("la,lb", PATH_WIDTHS)
def test_ff_kernel_paths_match_plain_on_card(cuda_device, la, lb, rows,
                                             path):
    ct = 2 + PATH_ROWS.index(rows) % 3
    a, b = _pair(rows + ct, (rows,), 16 * la, 16 * lb)
    a, b = TL.from_numpy(a, cuda_device), TL.from_numpy(b, cuda_device)
    before = _build.path_counts()["mcim_fold_ff"][path]
    if path == "bulk" and TF.fold_launch_plan(rows, la, lb, True) != "bulk":
        with pytest.raises(ValueError, match="bulk"):
            TF.mcim_fold_kernel(a, b, schedule="ff", path=path)
        return
    got = _counted("mcim_fold_ff", TF.mcim_fold_kernel, a, b,
                   schedule="ff", path=path)
    assert torch.equal(got, TF.mcim_fold_mul_ref(a, b, ct=ct,
                                                 schedule="ff"))
    assert _build.path_counts()["mcim_fold_ff"][path] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("la", (2, 8))
def test_bank_and_ff_kernels_on_misaligned_views(cuda_device, la):
    """Views 4 bytes off a 16-byte boundary take the per-thread path
    through the public entry points, as ``big_mul(a[3:], b[3:])`` does."""
    a, b, owner, table = _bank_operands(3, 1000, la, la, cuda_device,
                                        offset=1)
    assert TB.launch_plan(3, 3000, la, la, False) == "per_thread"
    got = _counted("bank_fold", TB.fused_bank_rows, a, b, owner, table)
    assert torch.equal(got, TB.fused_bank_mul_ref(a, b, owner, table))
    fa, fb = _pair(la, (1003,), 16 * la)
    fa, fb = TL.from_numpy(fa, cuda_device), TL.from_numpy(fb, cuda_device)
    got = _counted("mcim_fold_ff", TF.big_mul, fa[3:], fb[3:], ct=2,
                   schedule="ff")
    assert torch.equal(got, TF.mcim_fold_mul_ref(fa[3:], fb[3:], ct=2,
                                                 schedule="ff"))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))        # bulk, per-thread
def test_bank_and_ff_kernels_replay_in_a_cuda_graph(cuda_device, offset):
    a, b, owner, table = _bank_operands(4, 300_032, 2, 2, cuda_device,
                                        offset)
    fa, fb = a, b
    run = lambda: (TB.fused_bank_rows(a, b, owner, table),  # noqa: E731
                   TF.mcim_fold_mul(fa, fb, ct=2, schedule="ff"))
    run()                                # first launches outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bank, ff = run()
    x, y = _bank_operands(4, 300_032, 2, 2, "cpu")[:2]
    a.copy_(y.to(cuda_device))           # new operands, same storage
    b.copy_(x.to(cuda_device))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(bank, TB.fused_bank_mul_ref(a, b, owner, table))
    assert torch.equal(ff, TF.mcim_fold_mul_ref(fa, fb, ct=2,
                                                schedule="ff"))


# ---- FB and the spatial Karatsuba on both paths of row_tiles.cuh (cuda)

# 1-limb rows (tbl8_w8 / tbl8_w16), 2 (star and fb of tp3p5_w32), 4
# (tbl8_w64_lowpower), 8 (tp5over6_w128), 13 (200-bit), 16, mixed widths
FB_WIDTHS = ((1, 1), (2, 2), (4, 4), (8, 8), (13, 13), (16, 16), (3, 5))
# around the tiles, odd counts (per-thread at 2 limbs), star's rows
FB_ROWS = (1, 7, 127, 129, 511, 513, 1001, 299_593)


def _worst_rows(a, b):
    """All-0xFFFF limbs in the first two rows: the largest columns."""
    a[:2], b[:2] = TL.MASK, TL.MASK
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("path", TF.PATHS)
@pytest.mark.parametrize("rows", FB_ROWS)
@pytest.mark.parametrize("la,lb", FB_WIDTHS)
def test_fb_kernel_paths_match_plain_on_card(cuda_device, la, lb, rows,
                                             path):
    ct = 1 + FB_ROWS.index(rows) % (lb + 2)      # star (CT=1) to CT > LB
    a, b = _worst_rows(*_pair(rows + ct, (rows,), 16 * la, 16 * lb))
    a, b = TL.from_numpy(a, cuda_device), TL.from_numpy(b, cuda_device)
    before = _build.path_counts()["mcim_fold_fb"][path]
    if path == "bulk" and TF.fold_launch_plan(rows, la, lb, True) != "bulk":
        with pytest.raises(ValueError, match="bulk"):
            TF.mcim_fold_kernel(a, b, schedule="fb", path=path)
        return
    got = _counted("mcim_fold_fb", TF.mcim_fold_kernel, a, b,
                   schedule="fb", path=path)
    assert torch.equal(got, TF.mcim_fold_mul_ref(a, b, ct=ct,
                                                 schedule="fb"))
    assert _build.path_counts()["mcim_fold_fb"][path] == before + 1
    assert TL.batch_from_limbs(got[:64]) == _products(
        a[:64].cpu().numpy(), b[:64].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("path", TK.PATHS)
@pytest.mark.parametrize("rows", (1, 7, 129, 513, 1000, 4097))
@pytest.mark.parametrize("n", (2, 4, 6, 8, 10, 12, 14, 16))
def test_karatsuba_ppm_kernel_paths_match_plain_on_card(cuda_device, n,
                                                        rows, path):
    a, b = _worst_rows(*_pair(n * rows, (rows,), 16 * n))
    a, b = TL.from_numpy(a, cuda_device), TL.from_numpy(b, cuda_device)
    before = _build.path_counts()["karatsuba_ppm"][path]
    if path == "bulk" and TK.launch_plan(rows, n, True) != "bulk":
        with pytest.raises(ValueError, match="bulk"):
            TK.karatsuba_ppm_kernel(a, b, path=path)
        return
    got = _counted("karatsuba_ppm", TK.karatsuba_ppm_kernel, a, b,
                   path=path)
    assert torch.equal(got, TK.karatsuba_ppm_mul_ref(a, b))
    assert _build.path_counts()["karatsuba_ppm"][path] == before + 1
    assert TL.batch_from_limbs(got[:64]) == _products(
        a[:64].cpu().numpy(), b[:64].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", (2, 8, 16))
def test_fb_and_karatsuba_kernels_on_misaligned_views(cuda_device, n):
    """Views 4 bytes off a 16-byte boundary take the per-thread path
    through the public entry points (the folded Karatsuba has no other
    path; here also at mixed and odd widths)."""
    a, b = _worst_rows(*_pair(n + 1, (1001,), 16 * n))
    a, b = _on_card(a, cuda_device, 1), _on_card(b, cuda_device, 1)
    assert TF.fold_launch_plan(1001, n, n, False) == "per_thread"
    for ct in (1, 2):
        before = _build.path_counts()["mcim_fold_fb"]["per_thread"]
        got = _counted("mcim_fold_fb", TF.big_mul, a, b, ct=ct)
        assert torch.equal(got, TF.mcim_fold_mul_ref(a, b, ct=ct))
        assert _build.path_counts()["mcim_fold_fb"]["per_thread"] == \
            before + 1
    before = _build.path_counts()["karatsuba_ppm"]["per_thread"]
    got = _counted("karatsuba_ppm", TK.kara_mul, a, b)
    assert torch.equal(got, TK.karatsuba_ppm_mul_ref(a, b))
    assert _build.path_counts()["karatsuba_ppm"]["per_thread"] == before + 1
    for la, lb in ((n, n), (n - 1, n), (3, 5)):     # the folded Karatsuba
        fa, fb_ = a[:, :la].contiguous(), b[:, :lb].contiguous()
        fa, fb_ = (_on_card(x.cpu().numpy(), cuda_device, 1)
                   for x in (fa, fb_))
        got = _counted("mcim_fold_karatsuba", TF.big_mul, fa, fb_, ct=3,
                       schedule="karatsuba")
        assert torch.equal(got, TF.mcim_fold_mul_ref(
            fa, fb_, ct=3, schedule="karatsuba"))


# ------------------------ the folded Karatsuba on the per-thread path (cuda)

@pytest.mark.cuda
@pytest.mark.parametrize("rows", (0, 1, 127, 129, 1001))
@pytest.mark.parametrize("lb", range(1, 17))
def test_kara_fold_kernel_matches_plain_on_card(cuda_device, lb, rows):
    """Every LA, LB <= 16 (rows zero-filled to an even N on the card),
    one launch a call (a call of 0 rows launches nothing)."""
    for la in range(1, 17):
        a, b = _pair(100 * la + lb + rows, (rows,), 16 * la, 16 * lb)
        if rows:
            a, b = _worst_rows(a, b)
        a, b = TL.from_numpy(a, cuda_device), TL.from_numpy(b, cuda_device)
        before = _build.launch_counts()["mcim_fold_karatsuba"]
        got = TF.mcim_fold_mul(a, b, ct=3, schedule="karatsuba")
        torch.cuda.synchronize()
        assert _build.launch_counts()["mcim_fold_karatsuba"] == \
            before + (rows > 0)
        assert got.shape == (rows, la + lb)
        assert torch.equal(got, TF.mcim_fold_mul_ref(a, b, ct=3,
                                                     schedule="karatsuba"))
        assert TL.batch_from_limbs(got) == _products(a.cpu().numpy(),
                                                     b.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("la,lb", ((8, 8), (13, 13), (3, 5)))
def test_kara_fold_kernel_replays_in_a_cuda_graph(cuda_device, la, lb,
                                                  offset):
    """A captured launch reads the operands' storage at replay: new
    values in the same storage give their own product."""
    a, b = (_on_card(x, cuda_device, offset)
            for x in _pair(la * lb, (4097,), 16 * la, 16 * lb))
    run = lambda: TF.mcim_fold_mul(a, b, ct=3,  # noqa: E731
                                   schedule="karatsuba")
    run()                                # first launch outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _build.launch_counts()["mcim_fold_karatsuba"]
    with torch.cuda.graph(graph):
        got = run()
    assert _build.launch_counts()["mcim_fold_karatsuba"] == before + 1
    x, y = _worst_rows(*_pair(la + lb, (4097,), 16 * la, 16 * lb))
    a.copy_(TL.from_numpy(x, cuda_device))
    b.copy_(TL.from_numpy(y, cuda_device))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, TF.mcim_fold_mul_ref(a, b, ct=3,
                                                 schedule="karatsuba"))
    assert TL.batch_from_limbs(got[:64]) == _products(x[:64], y[:64])


@pytest.mark.cuda
def test_bulk_entry_points_refuse_and_never_reroute(cuda_device):
    """The C bulk entry points return cudaErrorInvalidValue (1) on what a
    bulk copy cannot take, launch nothing and write nothing: they never
    hand the launch to the per-thread path."""
    a, b = _pair(3, (1001,), 128)
    a, b = _on_card(a, cuda_device, 1), _on_card(b, cuda_device, 1)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.full((1001, 16), -1, dtype=torch.int32, device=cuda_device)
    bulk = _build.launcher("mcim_fold", "mcim_fold_bulk_launch", 3, 3)
    kara = _build.launcher("karatsuba_ppm", "karatsuba_ppm_bulk_launch", 3,
                           2)
    ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr())
    assert bulk(*ptrs, 1001, 8, 8, stream) == 1            # misaligned
    assert kara(*ptrs, 1000, 2, stream) == 1
    whole = torch.zeros((1001, 8), dtype=torch.int32, device=cuda_device)
    ptrs = (whole.data_ptr(), whole.data_ptr(), out.data_ptr())
    assert bulk(*ptrs, 1001, 4, 8, stream) == 1            # LA != LB
    assert bulk(*ptrs, 1001, 6, 6, stream) == 1            # 6 limbs
    assert kara(*ptrs, 1001, 2, stream) == 1               # odd rows
    assert kara(*ptrs, 1000, 8, stream) == 1               # N = 8
    torch.cuda.synchronize()
    assert bool((out == -1).all())
    for schedule in ("fb", "ff"):
        with pytest.raises(ValueError, match="bulk"):
            TF.mcim_fold_kernel(a, b, schedule=schedule, path="bulk")
    with pytest.raises(ValueError, match="bulk"):
        TK.karatsuba_ppm_kernel(a, b, path="bulk")
