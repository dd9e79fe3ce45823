#!/usr/bin/env python3
"""How far a dense model's decode steps drift from fresh prefills, by
depth and by rounding scheme.

    PYTHONPATH=src python3 scripts/decode_drift.py             # one card
    PYTHONPATH=src python3 scripts/decode_drift.py --smoke --device cpu

For each scheme it prefills 2 x P0 tokens, decodes 3 teacher-forced
steps and holds each step's logits against a fresh prefill's last
position: max|d| / std (the reference's measure,
``tests/test_decode_consistency.py``).  Schemes:

  port       ``repro_torch.models`` as it is: every projection on fixed
             64-row matmul calls, attention summed in float64 after a
             pass for each row's max;
  reference  the JAX package's rounding: one matmul call for all rows
             (cuBLAS picks its kernel by the row count), decode rounds
             the normalized softmax, flash attention rescales chunk by
             chunk in float32;
  matmul     the port's matmul with the reference's attention;
  attention  the port's attention with one matmul call for all rows.

It runs gemma2-9b (full width, depths 1, 8, 16 and 42; under the
reference scheme also in float32 weights and caches) and gemma3-1b
(26 layers, prefixes of 64 and 1,024 tokens), and times the gemma2-9b
decode step of each scheme as a CUDA graph; on the card it also counts
the elements of layer 0's projections that round apart between 2 and
130 rows.  ``--smoke`` takes the reduced configs (for a CPU rehearsal).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import decode_graph_ms, rel_err  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import base as B  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

PORT_MATMUL, PORT_FLASH, PORT_DECODE = B.matmul, T.flash_attention, \
    T.decode_attention


def plain_matmul(x, w):
    return x @ w


def ref_flash(q, k, v, *, mask_kind="causal", window=None, prefix_len=None,
              logit_cap=None, q_chunk=512, k_chunk=512, schedule="masked"):
    """The JAX package's online softmax (masked schedule), float32."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    q = q.reshape(b, sq, kv, g, d)
    q_chunk, k_chunk = min(q_chunk, sq), min(k_chunk, sk)
    if sq % q_chunk or sk % k_chunk:
        q_chunk, k_chunk = sq, sk
    outs = []
    for qi in range(sq // q_chunk):
        m = torch.full((b, kv, g, q_chunk), A.NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kv, g, q_chunk, d), device=q.device)
        qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        for ki in range(sk // k_chunk):
            kpos = ki * k_chunk + torch.arange(k_chunk, device=q.device)
            s = torch.einsum("bqkgd,bskd->bkgqs",
                             q[:, qi * q_chunk:(qi + 1) * q_chunk].float(),
                             k[:, ki * k_chunk:(ki + 1) * k_chunk].float())
            s = s * (1.0 / math.sqrt(d))
            if logit_cap is not None:
                s = torch.tanh(s / logit_cap) * logit_cap
            s = torch.where(A._chunk_mask(qpos, kpos, mask_kind, window,
                                          prefix_len), s, A.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(v.dtype).float(),
                v[:, ki * k_chunk:(ki + 1) * k_chunk].float())
            m = m_new
        outs.append((acc / l.clamp(min=1e-30)[..., None])
                    .permute(0, 3, 1, 2, 4))
    return torch.cat(outs, 1).reshape(b, sq, h, d).to(v.dtype)


def ref_decode(q, k_cache, v_cache, valid, *, logit_cap=None):
    """The JAX package's decode attention: the normalized softmax rounds
    to the working dtype before P.V."""
    b, _, h, d = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, 1, kv, h // kv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float())
    s = s * (1.0 / math.sqrt(d))
    if logit_cap is not None:
        s = torch.tanh(s / logit_cap) * logit_cap
    s = torch.where(valid[:, None, None, None, :], s, A.NEG_INF)
    p = torch.softmax(s, -1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, d).to(v_cache.dtype)


SCHEMES = {
    "port": (PORT_MATMUL, PORT_FLASH, PORT_DECODE),
    "reference": (plain_matmul, ref_flash, ref_decode),
    "matmul": (PORT_MATMUL, ref_flash, ref_decode),
    "attention": (plain_matmul, PORT_FLASH, PORT_DECODE),
}


def use(scheme):
    B.matmul, T.flash_attention, T.decode_attention = SCHEMES[scheme]


def truncated(model, full_layers, cfg, n):
    """``model`` cut to its first ``n`` layers (shared weights)."""
    model.layers = torch.nn.ModuleList(full_layers[:n])
    model.cfg = dataclasses.replace(cfg, n_layers=n)
    return model


def drift(model, toks, p0, s_cap):
    b = toks.shape[0]
    caches, _ = model.prefill({"tokens": toks[:, :p0]}, s_cap=s_cap)
    errs = []
    for j in range(toks.shape[1] - p0):
        pos = torch.full((b,), p0 + j, device=toks.device)
        caches, dec = model.decode_step(caches, toks[:, p0 + j], pos)
        _, ref = model.prefill({"tokens": toks[:, :p0 + j + 1]},
                               s_cap=s_cap)
        errs.append(rel_err(dec, ref))
    return errs


def graph_ms(model, slots=4, s_cap=56):
    """Device milliseconds of one decode step replayed from a CUDA graph."""
    dev = model.device
    caches = T.init_cache(T.lm_cache_spec(model.cfg, slots, s_cap), dev)
    return decode_graph_ms(model, caches, torch.arange(slots, device=dev),
                           torch.full((slots,), s_cap // 2, device=dev))


def projection_flips(model, dev):
    """Share of each layer-0 projection's bf16 outputs that differ
    between a 2-row and a 130-row call (one matmul call each)."""
    layer = model.layers[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((130, model.cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    h = torch.randn((130, model.cfg.d_ff), generator=gen,
                    device=dev).to(torch.bfloat16)
    out = {}
    for name, inp, w in (("wq", x, layer.attn.wq), ("wk", x, layer.attn.wk),
                         ("wv", x, layer.attn.wv),
                         ("w_gate", x, layer.mlp.w_gate),
                         ("w_down", h, layer.mlp.w_down)):
        full, few = inp @ w, inp[-2:] @ w
        out[name] = (full[-2:] != few).float().mean().item()
    return out


def fmt(errs):
    return "[" + ", ".join(f"{e:.4f}" for e in errs) + "]"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    gen = torch.Generator(device=dev)

    cfg = get_config("gemma2-9b", smoke=args.smoke)
    model = build_model(cfg, dev).init(gen.manual_seed(0))
    full_layers = list(model.layers)
    depths = sorted({1, min(8, cfg.n_layers), min(16, cfg.n_layers),
                     cfg.n_layers})
    toks = torch.randint(0, cfg.vocab_size, (2, 67),
                         generator=gen.manual_seed(2), device=dev)
    if on_card:
        use("reference")
        print("gemma2-9b layer 0, outputs rounding apart at 2 vs 130 rows: "
              + ", ".join(f"{k} {v:.4%}" for k, v in
                          projection_flips(model, dev).items()))
    for scheme in SCHEMES:
        use(scheme)
        for n in depths:
            truncated(model, full_layers, cfg, n)
            print(f"gemma2-9b {scheme:9s} {n:2d} layers: decode vs prefill "
                  f"{fmt(drift(model, toks, 64, 128))}", flush=True)
        if on_card:
            print(f"gemma2-9b {scheme:9s} decode step as a CUDA graph "
                  f"(4 slots, s_cap 56): {graph_ms(model):.3f} ms",
                  flush=True)
    use("reference")
    bf16_spec = T.attn_cache_spec
    T.attn_cache_spec = lambda *a: {
        k: T.TensorSpec(s.shape, torch.float32 if s.dtype == torch.bfloat16
                        else s.dtype) for k, s in bf16_spec(*a).items()}
    model.float()
    print(f"gemma2-9b reference {cfg.n_layers} layers, float32 weights and "
          f"caches: {fmt(drift(model, toks, 64, 128))}", flush=True)
    T.attn_cache_spec = bf16_spec
    del model, full_layers
    if on_card:
        torch.cuda.empty_cache()

    cfg3 = get_config("gemma3-1b", smoke=args.smoke)
    model = build_model(cfg3, dev).init(gen.manual_seed(3))
    long = 1024 if not args.smoke else 2 * cfg3.window
    for p0 in (64, long):
        toks = torch.randint(0, cfg3.vocab_size, (2, p0 + 3),
                             generator=gen.manual_seed(4), device=dev)
        for scheme in ("port", "matmul"):
            use(scheme)
            print(f"gemma3-1b {scheme:9s} prefix {p0}: decode vs prefill "
                  f"{fmt(drift(model, toks, p0, p0 + 24))}", flush=True)
    use("port")


if __name__ == "__main__":
    main()
