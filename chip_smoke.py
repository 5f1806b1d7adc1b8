"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. the card: refuse to run without CUDA (no CPU fallback), print the
     card's name and power limit (nvidia-smi);
  2. build: compile every CUDA kernel of the serving path from csrc/
     (one nvcc per source, all at once);
  3. kernels: every (head_dim, group) instantiation at small shapes, then
     at llama3-8b attention geometry (Hq 32, Hkv 8, D 128,
     BS 128, bf16) hold each kernel against its plain PyTorch version on
     the same inputs (bf16 kernel output against the f32 plain version,
     atol = rtol = 2e-2) and time kernel, plain version and the library
     yardstick (scaled_dot_product_attention over the gathered context),
     beside the card's least possible time for the same work;
  4. serve: full-width llama3-8b (32 layers, seeded random bf16 weights)
     behind the port's HTTP instance, 6 concurrent /v1/completions
     (prompts of 40 to 3000 tokens, one chunked; one prompt twice),
     checking 32 greedy tokens each, equal tokens for the equal prompts,
     launches of both kernels during the run, the kernel report, and the
     model's prefill logits against a dense causal reference forward.

Prints the card line and one JSON line of kernel records before the last
line, which is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

import torch

# H100 SXM published peaks (dense): bf16 tensor cores and HBM bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
ATOL = RTOL = 2e-2
SEED = 1234
BS = 128
HQ, HKV, D = 32, 8, 128


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() over `iters` launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def compare(card: str, name: str, out: torch.Tensor, ref: torch.Tensor,
            tol: float = ATOL) -> float:
    err = (out.float() - ref.float()).abs()
    max_err = float(err.max())
    bad = err > tol + tol * ref.float().abs()
    if not torch.isfinite(out.float()).all() or bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements off "
            f"(max abs err {max_err:.4g}, atol=rtol={tol})"
        )
    print(f"  [{card}] {name}: max abs err {max_err:.4g} (atol=rtol={tol})")
    return max_err


def check_geometries(gen, card) -> None:
    """Every (head_dim, GQA group) instantiation the kernels carry, at a
    small block size and odd lengths: bf16 (and f32 for decode, which
    takes it, at atol=rtol=1e-4) against the plain versions."""
    from xllm_service_tpu_torch.ops import attention, kernels

    dev, bs, hkv = "cuda", 16, 2
    for d in (64, 128, 256):
        for g in (1, 2, 4, 8):
            k = torch.randn(40, hkv, bs, d, generator=gen, device=dev)
            v = torch.randn(40, hkv, bs, d, generator=gen, device=dev)
            bt = (torch.randperm(39, generator=gen, device=dev)[:36] + 1).int().reshape(3, 12)
            q = torch.randn(3, hkv * g, d, generator=gen, device=dev)
            sl = torch.tensor([1, 150, 0], dtype=torch.int32, device=dev)
            for dt, tol in ((torch.bfloat16, ATOL), (torch.float32, 1e-4)):
                qi, ki, vi = q.to(dt), k.to(dt), v.to(dt)
                ref = attention.paged_attention_gather(qi.float(), ki.float(), vi.float(), bt,
                                                       sl, d**-0.5, window=40)
                out = kernels.paged_attention(qi, ki, vi, bt, sl, d**-0.5, window=40)
                compare(card, f"paged_attention D={d} G={g} {dt}", out, ref, tol)
            qp = torch.randn(3, 70, hkv * g, d, generator=gen, device=dev)
            sp = torch.tensor([0, 33, 5], dtype=torch.int32, device=dev)
            tl = torch.tensor([70, 5, 0], dtype=torch.int32, device=dev)
            qb, kb, vb = qp.bfloat16(), k.bfloat16(), v.bfloat16()
            ref = attention.prefill_attention_plain(qb.float(), kb.float(), vb.float(), bt,
                                                    sp, tl, d**-0.5)
            out = kernels.flash_prefill(qb, kb, vb, bt, sp, tl, d**-0.5)
            compare(card, f"flash_prefill D={d} G={g}", out, ref)


def sdpa_gqa(q, k, v, mask, scale):
    """The library yardstick: one scaled_dot_product_attention call over
    the gathered context (q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D])."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


# --------------------------------------------------------------- kernels


def check_decode(gen, card):
    from xllm_service_tpu_torch.ops import attention, kernels

    dev = "cuda"
    ctx = [1, 127, 128, 129, 1000, 2048, 4096, 0]  # last row dead
    R, MB = len(ctx), 4096 // BS
    N = R * MB + 1
    q = torch.randn(R, HQ, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(N, HKV, BS, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(N, HKV, BS, D, generator=gen, device=dev).bfloat16()
    bt = (torch.randperm(N - 1, generator=gen, device=dev)[: R * MB] + 1).int().reshape(R, MB)
    sl = torch.tensor(ctx, dtype=torch.int32, device=dev)
    scale = D**-0.5
    errs = []
    for window in (0, 300):
        out = kernels.paged_attention(q, k, v, bt, sl, scale, window=window)
        ref = attention.paged_attention_gather(q.float(), k.float(), v.float(), bt, sl, scale,
                                               window=window)
        torch.cuda.synchronize()
        errs.append(compare(card, f"paged_attention window={window}", out, ref))
    assert bool((out[-1] == 0).all()), "dead decode row must be zero"

    kernel_ms = time_ms(lambda: kernels.paged_attention(q, k, v, bt, sl, scale))
    plain_ms = time_ms(lambda: attention.paged_attention_gather(q, k, v, bt, sl, scale), iters=5)
    k_ctx, v_ctx = attention.gather_context(k, v, bt)
    k_ctx, v_ctx = k_ctx.transpose(1, 2).contiguous(), v_ctx.transpose(1, 2).contiguous()
    cols = torch.arange(k_ctx.shape[2], device=dev)
    mask = (cols[None, :] < sl[:, None].clamp(min=1))[:, None, None, :]
    library_ms = time_ms(lambda: sdpa_gqa(q[:, :, None], k_ctx, v_ctx, mask, scale))
    live = sum(ctx)
    nbytes = live * HKV * D * 2 * 2 + 2 * q.numel() * 2 + bt.numel() * 4 + R * 4
    bound_ms, bound_by = bound(4.0 * live * HQ * D, nbytes)
    return {
        "name": "paged_attention", "route": "cuda",
        "source": "xllm_service_tpu_torch/csrc/paged_attention.cu",
        "replaces": kernels.PAGED_ATTENTION.replaces,
        "max_abs_err": max(errs), "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_prefill(gen, card):
    from xllm_service_tpu_torch.ops import attention, kernels

    dev = "cuda"
    P, Lpad = 2, 512
    start = [0, 1024]
    tlen = [512, 300]
    MB = (1024 + Lpad) // BS
    N = P * MB + 1
    q = torch.randn(P, Lpad, HQ, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(N, HKV, BS, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(N, HKV, BS, D, generator=gen, device=dev).bfloat16()
    bt = (torch.randperm(N - 1, generator=gen, device=dev)[: P * MB] + 1).int().reshape(P, MB)
    sp = torch.tensor(start, dtype=torch.int32, device=dev)
    tl = torch.tensor(tlen, dtype=torch.int32, device=dev)
    scale = D**-0.5
    errs = []
    for window in (0, 200):
        out = kernels.flash_prefill(q, k, v, bt, sp, tl, scale, window=window)
        ref = attention.prefill_attention_plain(q.float(), k.float(), v.float(), bt, sp, tl,
                                                scale, window=window)
        torch.cuda.synchronize()
        errs.append(compare(card, f"flash_prefill window={window}", out, ref))
    assert bool((out[1, tlen[1]:] == 0).all()), "rows past true_len must be zero"

    kernel_ms = time_ms(lambda: kernels.flash_prefill(q, k, v, bt, sp, tl, scale))
    plain_ms = time_ms(lambda: attention.prefill_attention_plain(q, k, v, bt, sp, tl, scale), iters=3)
    k_ctx, v_ctx = attention.gather_context(k, v, bt)
    k_ctx, v_ctx = k_ctx.transpose(1, 2).contiguous(), v_ctx.transpose(1, 2).contiguous()
    rows = sp[:, None] + torch.arange(Lpad, device=dev)[None, :]
    cols = torch.arange(k_ctx.shape[2], device=dev)
    mask = (cols[None, None, :] <= rows[:, :, None]) & (
        torch.arange(Lpad, device=dev)[None, :, None] < tl[:, None, None])
    mask[:, :, 0] |= True  # keep fully masked padding rows finite
    library_ms = time_ms(lambda: sdpa_gqa(q.transpose(1, 2), k_ctx, v_ctx, mask[:, None], scale))
    attended = sum(s * n + n * (n + 1) // 2 for s, n in zip(start, tlen))
    ctx_tokens = sum(s + n for s, n in zip(start, tlen))
    nbytes = ctx_tokens * HKV * D * 2 * 2 + 2 * q.numel() * 2 + bt.numel() * 4 + 2 * P * 4
    bound_ms, bound_by = bound(4.0 * attended * HQ * D, nbytes)
    return {
        "name": "flash_prefill", "route": "cuda",
        "source": "xllm_service_tpu_torch/csrc/flash_prefill.cu",
        "replaces": kernels.FLASH_PREFILL.replaces,
        "max_abs_err": max(errs), "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


# --------------------------------------------------------------- serve


def dense_reference_logits(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Last-position logits of a plain causal forward (no KV cache, f32
    attention over the whole prompt): the reference the served model's
    cached prefill + decode path is held against."""
    import torch.nn.functional as F

    from xllm_service_tpu_torch.ops import rope
    from xllm_service_tpu_torch.ops.norms import rms_norm

    lp, eps = params["layers"], cfg.rms_norm_eps
    L, G = tokens.shape[0], cfg.num_heads // cfg.num_kv_heads
    x = params["embed"][tokens]
    cos, sin = rope.rope_tables(torch.arange(L, device=tokens.device), cfg, cfg.head_dim)
    causal = torch.tril(torch.ones(L, L, dtype=torch.bool, device=tokens.device))
    for i in range(cfg.num_layers):
        h = rms_norm(x, lp["attn_norm"][i], eps)
        q = rope.rotate((h @ lp["wq"][i]).reshape(L, cfg.num_heads, cfg.head_dim), cos, sin)
        k = rope.rotate((h @ lp["wk"][i]).reshape(L, cfg.num_kv_heads, cfg.head_dim), cos, sin)
        v = (h @ lp["wv"][i]).reshape(L, cfg.num_kv_heads, cfg.head_dim)
        qf = q.float().reshape(L, cfg.num_kv_heads, G, cfg.head_dim)
        s = torch.einsum("qhgd,khd->hgqk", qf, k.float()) * cfg.head_dim**-0.5
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("hgqk,khd->qhgd", p, v.float()).reshape(L, -1).to(x.dtype)
        x = x + o @ lp["wo"][i]
        h = rms_norm(x, lp["mlp_norm"][i], eps)
        x = x + (F.silu(h @ lp["w_gate"][i]) * (h @ lp["w_up"][i])) @ lp["w_down"][i]
    h = rms_norm(x[-1:], params["final_norm"], eps)
    return (h @ params["lm_head"]).float()[0]


def check_model_path(ex, card) -> None:
    """The served model's prefill (flash kernel) + one decode step (decode
    kernel) against the dense reference on a 200-token input."""
    from xllm_service_tpu_torch.models import llama

    cfg, dev = ex.cfg, ex.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    toks = torch.randint(3, cfg.vocab_size, (201,), generator=gen, device=dev)
    L = 200
    table = torch.arange(1, 3, dtype=torch.int32, device=dev)[None]  # blocks 1, 2
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    with torch.inference_mode():
        pf_logits, _, _ = llama.prefill_batch_step(
            ex.params, cfg, ex.k_cache, ex.v_cache, toks[None, :L], i32(0), i32(L), table)
        dec_logits, _, _ = llama.decode_step(
            ex.params, cfg, ex.k_cache, ex.v_cache, toks[L:], i32(L), table,
            torch.ones(1, dtype=torch.bool, device=dev))
        for name, got, n in (("prefill", pf_logits[0], L), ("decode", dec_logits[0], L + 1)):
            ref = dense_reference_logits(ex.params, cfg, toks[:n])
            rel = float((got - ref).norm() / ref.norm())
            same = int(got.argmax()) == int(ref.argmax())
            print(f"  [{card}] {cfg.name} {name} logits vs dense reference: "
                  f"rel L2 err {rel:.4g}, argmax equal {same}")
            if not torch.isfinite(got).all() or rel > 5e-2:
                raise AssertionError(f"{name} logits disagree with the dense reference ({rel})")


def post(address: str, body: dict, out: dict) -> None:
    """One /v1/completions call; fills out[token_ids, t_first, t_end]."""
    req = urllib.request.Request(
        f"http://{address}/v1/completions", json.dumps(body).encode(),
        {"Content-Type": "application/json"},
    )
    t0 = time.monotonic()
    out["t0"] = t0
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not body.get("stream"):
            data = json.loads(resp.read())
            out["token_ids"] = data["choices"][0]["token_ids"]
            out["t_end"] = time.monotonic()
            return
        ids = []
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            for ch in json.loads(line[6:]).get("choices", []):
                if ch["token_ids"] and "t_first" not in out:
                    out["t_first"] = time.monotonic()
                ids += ch["token_ids"]
        out["token_ids"] = ids
        out["t_end"] = time.monotonic()


def serve(card: str) -> dict:
    from xllm_service_tpu_torch.api.instance import InstanceServer
    from xllm_service_tpu_torch.common.config import EngineConfig
    from xllm_service_tpu_torch.ops import kernels
    from xllm_service_tpu_torch.runtime.engine import InferenceEngine
    from xllm_service_tpu_torch.runtime.executor import ModelExecutor

    cfg = EngineConfig(
        model="llama3-8b", dtype="bfloat16", block_size=BS, num_blocks=1024,
        max_running_requests=8, max_prefill_tokens=2048, max_seq_len=8192,
    )
    t = time.monotonic()
    ex = ModelExecutor(cfg, device="cuda", init_seed=SEED)
    torch.cuda.synchronize()
    print(f"  [{card}] llama3-8b seeded bf16 weights + 1024-block KV pool: "
          f"{time.monotonic() - t:.1f} s")
    check_model_path(ex, card)
    server = InstanceServer(cfg, engine=InferenceEngine(cfg, executor=ex, eos_token_ids=(2,)))
    server.start()
    try:
        common = {"max_tokens": 32, "temperature": 0, "ignore_eos": True}
        post(server.address, dict(common, prompt=[5] * 40, max_tokens=2), {})  # warm-up
        lengths = [40, 300, 900, 900, 1500, 3000]
        assert max(lengths) > cfg.max_prefill_tokens  # one prompt prefills in chunks
        rng = torch.Generator().manual_seed(SEED)
        prompts = [torch.randint(3, ex.cfg.vocab_size, (n,), generator=rng).tolist()
                   for n in lengths]
        prompts[3] = prompts[2]  # the same prompt twice
        bodies = [dict(common, prompt=p, stream=i % 2 == 0) for i, p in enumerate(prompts)]
        outs = [{} for _ in bodies]
        kernels.reset_launch_counts()
        t_start = time.monotonic()
        threads = [threading.Thread(target=post, args=(server.address, b, o))
                   for b, o in zip(bodies, outs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.monotonic() - t_start
        counts = kernels.launch_counts()
        report = ex.kernel_report()
    finally:
        server.stop()
    for i, o in enumerate(outs):
        n = len(o.get("token_ids", ()))
        if n != 32:
            raise AssertionError(f"request {i} ({lengths[i]} prompt tokens) got {n} tokens, not 32")
    if outs[2]["token_ids"] != outs[3]["token_ids"]:
        raise AssertionError("the same prompt gave different greedy tokens")
    if report["decode"] != "cuda:paged_attention" or report["prefill"] != "cuda:flash_prefill":
        raise AssertionError(f"kernel report names {report}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} never launched on the serving path")
    ttft = [o["t_first"] - o["t0"] for o in outs if "t_first" in o]
    decode_rate = [31 / (o["t_end"] - o["t_first"]) for o in outs if "t_first" in o]
    total = sum(len(o["token_ids"]) for o in outs)
    stats = {
        "requests": len(outs), "prompt_tokens": sum(lengths), "generated_tokens": total,
        "wall_s": wall, "ttft_s": ttft, "decode_tok_s_per_request": decode_rate,
        "total_tok_s": total / wall, "launches": counts, "kernel_report": report,
        "engine_steps": server.engine.steps, "mixed_steps": server.engine.mixed_steps,
    }
    print(f"  [{card}] served {len(outs)} requests, {sum(lengths)} prompt tokens, "
          f"{total} generated in {wall:.3f} s: TTFT (stream) {[round(x, 4) for x in ttft]} s, "
          f"decode {[round(x, 2) for x in decode_rate]} tok/s per request, "
          f"total {total / wall:.2f} tok/s; launches {counts}; report {report}; "
          f"engine steps {server.engine.steps} (mixed {server.engine.mixed_steps})")
    return stats


# --------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    from xllm_service_tpu_torch.ops import kernels

    t = time.monotonic()
    kernels.build_all()
    print(f"[{card}] built {[k.name for k in kernels.KERNELS]} in {time.monotonic() - t:.1f} s")
    for k in kernels.KERNELS:
        spills = [ln for ln in k.build_log.splitlines() if "spill" in ln and " 0 bytes spill" not in ln]
        print(f"  {k.name}: {len(spills)} ptxas lines with spills" + (f", e.g. {spills[0].strip()}" if spills else ""))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    check_geometries(gen, card)
    records = [check_decode(gen, card), check_prefill(gen, card)]
    for r in records:
        print(f"  [{card}] {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    stats = serve(card)
    for r in records:
        r["launches"] = stats["launches"][r["name"]]
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
