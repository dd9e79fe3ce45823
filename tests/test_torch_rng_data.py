"""The port's ``rng`` (Philox on the MCIM 32x32 multiply) and ``data``
(deterministic sources) against the JAX reference's ``repro.rng`` and
``repro.data``, on the CPU, bit for bit (uint32 lanes as integers,
uniforms as float32 bits, batches as int32/float32 arrays), including
offsets past 2^31 and the Random123 known vector."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro import data as RD
from repro.rng import philox as RP
from repro_torch import data as TD
from repro_torch.rng import philox as TP

#: offsets around 2^31 and 2^32 and past it (the reference takes them
#: as uint32, wrapped; the port masks them), small ones and a block
OFFSETS = np.concatenate([
    np.arange(0, 300), np.arange(2**31 - 150, 2**31 + 150),
    np.arange(2**32 - 100, 2**32 + 100),
    np.array([123_456_789, 3_000_000_000, 2**33 + 1, 2**40 + 3])])
SEEDS = (0, 42, 2**32 + 7, 2**63 - 1)


def _ref_offsets():
    return jnp.asarray(OFFSETS.astype(np.uint32))


def _offsets():
    return torch.from_numpy(OFFSETS.astype(np.int64))


def test_philox_known_vector():
    """Philox4x32-10 reference vector (Random123): counter=0, key=0."""
    out = TP.philox4x32(torch.zeros((1, 4), dtype=torch.int64),
                        torch.zeros((1, 2), dtype=torch.int64))[0]
    expect = [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert out.tolist() == expect


@pytest.mark.parametrize("rounds", (1, 7, 10))
def test_philox4x32_matches_reference(rounds):
    rng = np.random.default_rng(rounds)
    ctr = rng.integers(0, 2**32, size=(500, 4), dtype=np.uint64)
    key = rng.integers(0, 2**32, size=(500, 2), dtype=np.uint64)
    ctr[:4] = [[0] * 4, [2**32 - 1] * 4, [1, 0, 0, 0], [0, 0, 0, 2**31]]
    key[:2] = [[0, 0], [2**32 - 1, 2**32 - 1]]
    want = RP.philox4x32(jnp.asarray(ctr.astype(np.uint32)),
                         jnp.asarray(key.astype(np.uint32)), rounds=rounds)
    got = TP.philox4x32(torch.from_numpy(ctr.astype(np.int64)),
                        torch.from_numpy(key.astype(np.int64)),
                        rounds=rounds)
    assert got.dtype == torch.int64 and got.shape == (500, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("stream", (1, 2, 3, 2**32 + 5))
def test_random_u32_matches_reference(seed, stream):
    want = RP.random_u32(seed, stream, _ref_offsets())
    got = TP.random_u32(seed, stream, _offsets())
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_uniform_matches_reference(seed):
    want = np.asarray(RP.random_uniform(seed, 7, _ref_offsets()))
    got = TP.random_uniform(seed, 7, _offsets()).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("vocab", (2, 1000, 256_000, 2**31 - 1))
def test_random_tokens_matches_reference(vocab):
    want = np.asarray(RP.random_tokens(3, 1, _ref_offsets(), vocab))
    got = TP.random_tokens(3, 1, _offsets(), vocab).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_random_uniform_determinism_and_uniformity():
    offs = torch.arange(0, 4096)
    u1 = TP.random_uniform(42, 7, offs).numpy()
    np.testing.assert_array_equal(u1, TP.random_uniform(42, 7, offs).numpy())
    assert 0.45 < u1.mean() < 0.55
    assert u1.min() >= 0 and u1.max() < 1
    assert not np.array_equal(u1, TP.random_uniform(43, 7, offs).numpy())


def _assert_batches_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


CFG = dict(vocab_size=1000, seq_len=16, global_batch=8, seed=5)


@pytest.mark.parametrize("hosts", ((0, 1), (0, 2), (1, 2), (3, 4)))
@pytest.mark.parametrize("source", ("synthetic", "pattern"))
def test_generated_sources_match_reference(source, hosts):
    ref = RD.make_source(RD.DataConfig(**CFG, source=source), *hosts)
    src = TD.make_source(TD.DataConfig(**CFG, source=source), *hosts,
                         device="cpu")
    assert type(src).__name__ == type(ref).__name__
    for step in (0, 3, 2**26 + 1):            # offsets past 2^32
        _assert_batches_equal(src.batch_at(step), ref.batch_at(step))


def test_binfile_source_matches_reference(tmp_path):
    corpus = np.random.default_rng(3).integers(0, 60000, 10_000,
                                               dtype=np.uint16)
    path = tmp_path / "corpus.bin"
    corpus.tofile(path)
    cfg = dict(vocab_size=60000, seq_len=64, global_batch=4,
               source="binfile", path=str(path))
    ref = RD.make_source(RD.DataConfig(**cfg))
    src = TD.make_source(TD.DataConfig(**cfg), device="cpu")
    for step in (0, 1, 1000):
        _assert_batches_equal(src.batch_at(step), ref.batch_at(step))
    b = src.batch_at(0)
    assert b["tokens"].shape == (4, 64)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_short_corpus_and_ragged_hosts_raise(tmp_path):
    path = tmp_path / "tiny.bin"
    np.zeros(8, np.uint16).tofile(path)
    with pytest.raises(ValueError, match="shorter than one window"):
        TD.BinTokenFile(TD.DataConfig(10, 16, 2, path=str(path)),
                        device="cpu")
    with pytest.raises(ValueError, match="divide"):
        TD.SyntheticLM(TD.DataConfig(**CFG), host_count=3, device="cpu")


def test_data_config_matches_reference_fields():
    assert [(f.name, f.default) for f in dataclasses.fields(TD.DataConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(RD.DataConfig)]


def test_device_batch_places_every_array():
    batch = TD.SyntheticLM(TD.DataConfig(**CFG), device="cpu").batch_at(0)
    out = TD.device_batch(batch, "cpu")
    for k, v in batch.items():
        assert out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), v)


def test_sources_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.SyntheticLM(TD.DataConfig(**CFG))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.device_batch({"x": np.zeros(2)})

