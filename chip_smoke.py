#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (incubator_mxnet_tpu_torch) end to end on one
NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which must pass, in order:

1. Build every CUDA kernel of the serving path from the checkout's sources
   (one nvcc per source, all started together).
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it and at a few ragged/odd ones, and time
   kernel, plain version and the PyTorch library call that computes the
   same function (a yardstick only; the port never calls it).
3. Hold a small BERT and GPT in float32 on the card (kernel route) against
   the same weights on the CPU (plain route).
4. The serving path: full-width BERT (bench.py bench_transformer config) and
   GPT (bench.py bench_long_context config) in bfloat16 behind one
   ModelRegistry on cuda:0, random weights from a seeded generator; 16 BERT
   requests of 512 tokens from 4 client threads (bucket 8) and one GPT
   request of 8192 tokens. Every reply must have the right shape and be
   finite, served BERT rows must match a direct EvalStep forward, and each
   kernel's launch count over this phase must equal the expected count.

Prints the card's name and power limit, a {"kernels": [...]} line and, as
the last line, {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when CUDA is absent, the port is not beside this script, or any
phase fails.
"""
import json
import os
import subprocess
import sys
import threading
import time

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 rate

BERT = dict(vocab_size=32768, units=1024, hidden_size=4096, num_layers=12,
            num_heads=8, max_length=512, dropout=0.0, attention="flash")
GPT = dict(vocab_size=32768, units=1024, num_layers=4, num_heads=8,
           max_length=8192, attention="flash")
BERT_S, BERT_BUCKET, BERT_REQUESTS, CLIENTS = 512, 8, 16, 4
GPT_S = 8192


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def timed_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(bh, s, d, causal, itemsize):
    """Least time for the flash forward: bf16 tensor-core flops of the two
    products (only the kept (row, col) pairs when causal) against reading
    q, k, v once and writing out and lse once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4.0 * bh * pairs * d
    nbytes = 4.0 * bh * s * d * itemsize + 4.0 * bh * s
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ------------------------------------------------------------------ phases
def build_kernels():
    from incubator_mxnet_tpu_torch.ops import _kernels, attention
    t0 = time.perf_counter()
    paths = _kernels.build(attention.SOURCE)
    log("build: %d kernel source(s) in %.1f s" % (len(paths),
                                                  time.perf_counter() - t0))
    for src, out in _kernels.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas %s: %s" % (src, line.strip()))


def check_flash_fwd():
    """K1 against _fa_reference (the same function in fp32, dense) on the
    same inputs. Tolerances: out in bf16/fp16 may differ by one rounding of
    the output type (rtol 2^-7 bf16, 2^-10 fp16, plus atol 1e-4); out in
    fp32 and lse (fp32 everywhere) by summation order (atol 2e-4, rtol
    1e-5)."""
    import torch
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import attention as A
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rtol_out = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
                torch.float32: 1e-5}

    def compare(tag, B, H, S, D, causal, dtype):
        q, k, v = (torch.randn(B, H, S, D, generator=gen, device=dev,
                               dtype=dtype) for _ in range(3))
        scale = 1.0 / D ** 0.5
        out, lse = A._flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        ref, ref_lse = A._fa_reference(q, k, v, causal, scale)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        check(torch.allclose(out.float(), ref.float(), rtol=rtol_out[dtype],
                             atol=1e-4),
              "%s: flash_fwd out differs from plain (max abs %.3g)"
              % (tag, err))
        check(torch.allclose(lse, ref_lse, rtol=1e-5, atol=2e-4),
              "%s: flash_fwd lse differs from plain (max abs %.3g)"
              % (tag, lse_err))
        log("  %-34s max|out-plain| %.3g  max|lse-plain| %.3g"
            % (tag, err, lse_err))
        return q, k, v, scale, max(err, lse_err)

    log("flash_fwd vs plain version:")
    for tag, shape, causal, dtype in (
            ("fp32 B2 H3 S1000 D64 causal", (2, 3, 1000, 64), True,
             torch.float32),
            ("fp16 B1 H4 S300 D128", (1, 4, 300, 128), False, torch.float16),
            ("bf16 B1 H2 S130 D64 causal", (1, 2, 130, 64), True,
             torch.bfloat16)):
        compare(tag, *shape, causal, dtype)

    served = []
    for tag, (B, H, S, D), causal, iters in (
            ("bert", (BERT_BUCKET, 8, BERT_S, 128), False, 50),
            ("gpt", (1, 8, GPT_S, 128), True, 10)):
        q, k, v, scale, err = compare("bf16 %s B%d H%d S%d D%d%s" % (
            tag, B, H, S, D, " causal" if causal else ""),
            B, H, S, D, causal, torch.bfloat16)
        check(A.flash_attention_legal(q.shape, k.shape, v.shape),
              "%s shape is not kernel-legal" % tag)
        ms = timed_ms(lambda: A._flash_fwd_cuda(q, k, v, causal, scale),
                      iters)
        plain_ms = timed_ms(lambda: A._fa_reference(q, k, v, causal, scale),
                            max(2, iters // 5))
        lib_ms = timed_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), iters)
        bound_ms, bound_by = attention_bound_ms(B * H, S, D, causal, 2)
        served.append(dict(shape="B%d H%d S%d D%d bf16%s" % (
            B, H, S, D, " causal" if causal else ""), max_abs_err=err,
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by))
        log("  %s: kernel %.4f ms  plain %.4f ms  sdpa %.4f ms  bound %.4f "
            "ms (%s)" % (tag, ms, plain_ms, lib_ms, bound_ms, bound_by))
        del q, k, v
    torch.cuda.empty_cache()
    return served


def check_small_models_against_cpu():
    """Small float32 BERT/GPT with head width 64: the card (kernel route)
    against the CPU (plain route) on the same weights; atol/rtol 1e-3 covers
    the two devices' float32 summation orders through two layers."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    from incubator_mxnet_tpu_torch.ops import _kernels
    tokens = onp.random.RandomState(0).randint(0, 1000, (2, 256)) \
        .astype("int32")
    for name, cls, kw in (
            ("bert", models.BERTModel, dict(hidden_size=512, dropout=0.0)),
            ("gpt", models.GPTModel, {})):
        net = cls(vocab_size=1000, units=128, num_layers=2, num_heads=2,
                  max_length=256, attention="flash", **kw)
        net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                       generator=torch.Generator().manual_seed(1))
        ref = mxt.jit.EvalStep(net)(tokens)
        before = _kernels.LAUNCHES.get("flash_fwd", 0)
        out = mxt.jit.EvalStep(net.to("cuda:0"))(tokens).cpu()
        check(_kernels.LAUNCHES.get("flash_fwd", 0) - before == 2,
              "small %s did not run flash_fwd once per layer" % name)
        err = (out - ref).abs().max().item()
        check(torch.allclose(out, ref, atol=1e-3, rtol=1e-3),
              "small %s: card and CPU disagree (max abs %.3g)" % (name, err))
        log("small %s fp32, card vs CPU: max abs diff %.3g" % (name, err))


def serve_full_width():
    """The main path through ModelRegistry; returns (launches, summary)."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models, serving
    from incubator_mxnet_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    bert = models.BERTModel(**BERT)
    bert.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=gen)
    bert.cast("bfloat16")
    gpt = models.GPTModel(**GPT)
    gpt.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=gen)
    gpt.cast("bfloat16")
    reg = serving.ModelRegistry()
    reg.load("bert", bert, max_batch_size=BERT_BUCKET, batch_timeout_ms=50)
    reg.load("gpt", gpt, max_batch_size=1)
    log("serving: models built and loaded in %.1f s"
        % (time.perf_counter() - t0))
    rng = onp.random.RandomState(0)
    bert_rows = rng.randint(0, 32768, (BERT_REQUESTS, BERT_S)).astype("int32")
    gpt_row = rng.randint(0, 32768, (GPT_S,)).astype("int32")
    try:
        # warm-up: one request each (library handles, first launches)
        reg.predict("bert", bert_rows[0])
        reg.predict("gpt", gpt_row)
        base = {n: reg.metrics(n).batch_count for n in ("bert", "gpt")}
        replies, lat, errors = {}, {"bert": [], "gpt": []}, []

        def bert_client(c):
            try:
                mine = range(c, BERT_REQUESTS, CLIENTS)
                t = time.perf_counter()
                reqs = {i: reg.submit("bert", bert_rows[i]) for i in mine}
                for i, r in reqs.items():
                    replies[i] = r.result(600)[0]
                    lat["bert"].append((time.perf_counter() - t) * 1e3)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        def gpt_client():
            try:
                t = time.perf_counter()
                replies["gpt"] = reg.predict("gpt", gpt_row)[0]
                lat["gpt"].append((time.perf_counter() - t) * 1e3)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=bert_client, args=(c,))
                   for c in range(CLIENTS)]
        threads.append(threading.Thread(target=gpt_client))
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_kernels.LAUNCHES)
        check(not any(t.is_alive() for t in threads), "a client hung")
        check(not errors, "requests failed: %r" % errors[:3])
        batches = {n: reg.metrics(n).batch_count - base[n]
                   for n in ("bert", "gpt")}
        hist = reg.metrics("bert").snapshot()["batch_size_hist"]
    finally:
        reg.close()

    expected = BERT["num_layers"] * batches["bert"] \
        + GPT["num_layers"] * batches["gpt"]
    check(launches.get("flash_fwd", 0) == expected,
          "flash_fwd launched %d times on the serving path, expected %d "
          "(%d layers x %d BERT batches + %d layers x %d GPT batches)"
          % (launches.get("flash_fwd", 0), expected, BERT["num_layers"],
             batches["bert"], GPT["num_layers"], batches["gpt"]))
    for i in range(BERT_REQUESTS):
        r = replies[i]
        check(r.shape == (BERT_S, 32768) and r.dtype == onp.float32,
              "bert reply %d has shape %s %s" % (i, r.shape, r.dtype))
        check(bool(onp.isfinite(r).all()), "bert reply %d not finite" % i)
    g = replies["gpt"]
    check(g.shape == (GPT_S, 32768) and bool(onp.isfinite(g).all()),
          "gpt reply has shape %s or is not finite" % (g.shape,))

    # served rows against a direct forward of the same row (bf16 GEMMs at
    # another batch size may round differently: allow 2% of the logit range)
    step = mxt.jit.EvalStep(bert)
    worst = 0.0
    for i in (0, BERT_REQUESTS - 1):
        direct = step(bert_rows[i][None])[0].float().cpu().numpy()
        diff = float(onp.abs(direct - replies[i]).max())
        worst = max(worst, diff)
        check(diff <= 0.02 * float(onp.abs(direct).max()) + 1e-3,
              "served bert row %d differs from EvalStep by %.3g" % (i, diff))
    breakdown = {"bert_bucket%d" % BERT_BUCKET:
                 stage_breakdown(bert, bert_rows[:BERT_BUCKET]),
                 "gpt": stage_breakdown(gpt, gpt_row[None])}
    summary = dict(
        breakdown=breakdown,
        bert_batches=batches["bert"], bert_batch_sizes=hist,
        gpt_batches=batches["gpt"], wall_ms=wall_ms,
        bert_latency_ms=sorted(lat["bert"]), gpt_latency_ms=lat["gpt"],
        served_vs_direct_max_abs=worst)
    log("serving: %d BERT requests in %d batches %s, 1 GPT request; "
        "wall %.1f ms" % (BERT_REQUESTS, batches["bert"], hist, wall_ms))
    log("serving: BERT latency ms p50 %.1f max %.1f; GPT latency ms %.1f; "
        "served-vs-direct max abs %.3g"
        % (sorted(lat["bert"])[len(lat["bert"]) // 2], max(lat["bert"]),
           lat["gpt"][0], worst))
    return launches, summary


def stage_breakdown(net, batch, reps=3):
    """Where one dispatched batch's time goes (warm, three repeats): the
    forward on the card (CUDA events), the same forward on the host clock
    (launch overhead included), and BlockServable's output conversion to
    float32 numpy on the host."""
    import torch
    from incubator_mxnet_tpu_torch import jit
    step = jit.EvalStep(net)
    out = {"forward_device_ms": [], "forward_host_ms": [], "to_host_ms": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        logits = step(batch)
        end.record()
        end.synchronize()
        t1 = time.perf_counter()
        logits.float().cpu().numpy()
        t2 = time.perf_counter()
        out["forward_device_ms"].append(start.elapsed_time(end))
        out["forward_host_ms"].append((t1 - t0) * 1e3)
        out["to_host_ms"].append((t2 - t1) * 1e3)
        del logits
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import incubator_mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: the port package is not beside this script (%s)"
              % e, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = (smi.stdout.strip().splitlines() or ["unknown"])[0]
    try:
        build_kernels()
        served = check_flash_fwd()
        check_small_models_against_cpu()
        launches, summary = serve_full_width()
    except SmokeFailure as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        return 1
    total = {key: sum(s[key] for s in served)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    kernel = dict(
        name="flash_fwd", route="cuda",
        source="incubator_mxnet_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="incubator_mxnet_tpu/ops/attention.py:103",
        launches=launches.get("flash_fwd", 0),
        max_abs_err=max(s["max_abs_err"] for s in served),
        ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"],
        bound_by=max(served, key=lambda s: s["bound_ms"])["bound_by"],
        library_ms=total["library_ms"],
        note="ms/plain_ms/bound_ms/library_ms: one launch at each served "
             "shape, summed; per shape in 'shapes'",
        shapes=served)
    log(json.dumps({"serving": summary}))
    log(json.dumps({"kernels": [kernel]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
