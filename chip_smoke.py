#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (incubator_mxnet_tpu_torch) end to end on one
NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which must pass, in order:

1. Build every CUDA kernel of the serving and training paths from the
   checkout's sources (flash_fwd.cu: K1; flash_bwd.cu: K2 and K3), one
   nvcc per source, all started together.
2. Hold K1 against its plain PyTorch version on the card, at the shapes the
   serving path gives it and at a few ragged/odd ones, and time kernel,
   plain version and the PyTorch library call that computes the same
   function (a yardstick only; the port never calls it).
3. Hold K2 (dK, dV) and K3 (dQ) against their plain version
   (_fa_bwd_reference), and the K1 out and lse that feed them against
   K1's plain version, on the card on the same inputs: fp32 S 1000 D 64
   causal, fp16 S 300 D 128 with a nonzero LSE cotangent, bf16 S 130 D 64
   causal, and the two training shapes, bf16 B 64 H 8 S 512 D 128 and
   B 1 H 8 S 8192 D 128 causal. Tolerances: in fp32 every gradient within
   1e-4 x max|plain|; in bf16/fp16 within one rounding of the type (2^-7
   bf16, 2^-10 fp16, relative) plus 1e-3 x max|plain|. At the training
   shapes, time K1, K2, K3, the plain forward and backward, and the
   forward and backward of scaled_dot_product_attention (the yardsticks
   for K1 and for the pair).
4. Hold a small BERT and GPT in float32 on the card (kernel route) against
   the same weights on the CPU (plain route): a forward, then three Adam
   TrainSteps (BERT with SoftmaxCrossEntropyLoss, FeaturesView(GPT) with
   ChunkedLMLoss); per-step losses and the parameters after three steps
   within 1e-3 (atol and rtol), the two devices' float32 summation orders.
5. The serving path: full-width BERT (bench.py bench_transformer config) and
   GPT (bench.py bench_long_context config) in bfloat16 behind one
   ModelRegistry on cuda:0, random weights from a seeded generator; 16 BERT
   requests of 512 tokens from 4 client threads (bucket 8) and one GPT
   request of 8192 tokens. Every reply must have the right shape and be
   finite, served BERT rows must match a direct EvalStep forward, K1's
   launch count over this phase must equal layers x batches, and K2/K3
   must not launch.
6. The training path, after the serving models are freed: full-width BERT
   (B 64 x S 512, SoftmaxCrossEntropyLoss on the full logits) and GPT
   (B 1 x S 8192, FeaturesView + ChunkedLMLoss) in bfloat16, each through
   gluon.Trainer("adam", lr 1e-4, multi_precision) and jit.TrainStep on a
   fixed batch: BERT 2 warm-up + 8 timed steps, GPT 2 + 4. Every loss
   finite, the last step's mean loss below the first's, every parameter
   finite, every bf16 weight equal to its fp32 master cast to bf16, and
   over the timed steps K1, K2 and K3 each launched layers x steps times.

Prints the card's name and power limit, a {"serving": ...}, a
{"training": ...} and a {"kernels": [...]} line and, as the last line,
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
CUDA is absent, the port is not beside this script, or any phase fails.
"""
import gc
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
BERT_TRAIN_B, BERT_TRAIN_STEPS = 64, (2, 8)      # (warm-up, timed)
GPT_TRAIN_B, GPT_TRAIN_STEPS = 1, (2, 4)


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


def attention_bwd_bound_ms(kernel, bh, s, d, causal, itemsize):
    """Least time for K2 ("dkv": 8·BH·pairs·D flops, writes dK and dV) or
    K3 ("dq": 6·BH·pairs·D flops, writes dQ): bf16 tensor-core flops
    against reading q, dO, k, v in the input type and lse, delta in fp32
    once, and writing the gradient(s) once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = (8.0 if kernel == "dkv" else 6.0) * bh * pairs * d
    n_out = 2 if kernel == "dkv" else 1
    nbytes = (4 + n_out) * bh * s * d * itemsize + 2.0 * 4 * bh * s
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ------------------------------------------------------------------ phases
def build_kernels():
    from incubator_mxnet_tpu_torch.ops import _kernels, attention
    t0 = time.perf_counter()
    paths = _kernels.build(attention.SOURCE, attention.BWD_SOURCE)
    log("build: %d kernel source(s) in %.1f s" % (len(paths),
                                                  time.perf_counter() - t0))
    for src, out in _kernels.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas %s: %s" % (src, line.strip()))


def hold_fwd(tag, q, k, v, out, lse, causal, scale):
    """K1's ``out`` and ``lse`` against _fa_reference (the same function in
    fp32, dense) on the same inputs; returns the larger max error.
    Tolerances: out in bf16/fp16 may differ by one rounding of the output
    type (rtol 2^-7 bf16, 2^-10 fp16, plus atol 1e-4); out in fp32 and lse
    (fp32 everywhere) by summation order (atol 2e-4, rtol 1e-5)."""
    import torch
    from incubator_mxnet_tpu_torch.ops import attention as A
    rtol_out = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
                torch.float32: 1e-5}
    ref, ref_lse = A._fa_reference(q, k, v, causal, scale)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    check(torch.allclose(out.float(), ref.float(), rtol=rtol_out[q.dtype],
                         atol=1e-4),
          "%s: flash_fwd out differs from plain (max abs %.3g)" % (tag, err))
    check(torch.allclose(lse, ref_lse, rtol=1e-5, atol=2e-4),
          "%s: flash_fwd lse differs from plain (max abs %.3g)"
          % (tag, lse_err))
    log("  %-40s max|out-plain| %.3g  max|lse-plain| %.3g"
        % (tag, err, lse_err))
    return max(err, lse_err)


def check_flash_fwd():
    """K1 against its plain version (``hold_fwd``) at ragged/odd shapes and
    the served shapes; at the served shapes also kernel, plain and SDPA
    times."""
    import torch
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import attention as A
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def compare(tag, B, H, S, D, causal, dtype):
        q, k, v = (torch.randn(B, H, S, D, generator=gen, device=dev,
                               dtype=dtype) for _ in range(3))
        scale = 1.0 / D ** 0.5
        out, lse = A._flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        return q, k, v, scale, hold_fwd(tag, q, k, v, out, lse, causal,
                                        scale)

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
    from incubator_mxnet_tpu_torch.ops import _kernels
    tokens = onp.random.RandomState(0).randint(0, 1000, (2, 256)) \
        .astype("int32")
    for name in ("bert", "gpt"):
        net = _small_pair(name)[0]
        ref = mxt.jit.EvalStep(net)(tokens)
        before = _kernels.LAUNCHES.get("flash_fwd", 0)
        out = mxt.jit.EvalStep(net.to("cuda:0"))(tokens).cpu()
        check(_kernels.LAUNCHES.get("flash_fwd", 0) - before == 2,
              "small %s did not run flash_fwd once per layer" % name)
        err = (out - ref).abs().max().item()
        check(torch.allclose(out, ref, atol=1e-3, rtol=1e-3),
              "small %s: card and CPU disagree (max abs %.3g)" % (name, err))
        log("small %s fp32, card vs CPU: max abs diff %.3g" % (name, err))


def check_flash_bwd():
    """K2 and K3 against _fa_bwd_reference (dense fp32 of the same
    recompute) on the same inputs, the forward's out and lse from K1, which
    is itself held against its plain version (``hold_fwd``) there.
    Returns {"dkv": [...], "dq": [...], "fwd": [...]}: per training shape,
    the max error, kernel ms, plain ms (the whole plain backward), bound,
    and SDPA's backward ms (the pair's yardstick); for K1 ("fwd") its max
    error, kernel ms, plain forward ms, bound and SDPA forward ms."""
    import torch
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import attention as A
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    rtol = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
            torch.float32: 0.0}
    atol_share = {torch.bfloat16: 1e-3, torch.float16: 1e-3,
                  torch.float32: 1e-4}

    def compare(tag, B, H, S, D, causal, dtype, with_g_lse):
        q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device=dev,
                                   dtype=dtype) for _ in range(4))
        scale = 1.0 / D ** 0.5
        o, lse = A._flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        err_fwd = hold_fwd(tag, q, k, v, o, lse, causal, scale)
        g_lse = torch.randn(B, H, S, generator=gen, device=dev) \
            if with_g_lse else None
        delta = A._bwd_delta(o, do, g_lse)
        dk, dv = A._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
        dq = A._flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()
        ref = A._fa_bwd_reference(q, k, v, o, lse, do, causal, scale, g_lse)
        errs = {}
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            got, want = got.float(), want.float()
            err = (got - want).abs()
            bound = rtol[dtype] * want.abs() \
                + atol_share[dtype] * want.abs().max()
            check(bool(torch.isfinite(got).all()) and bool((err <= bound)
                                                           .all()),
                  "%s: %s differs from plain (max abs %.3g, max|plain| %.3g)"
                  % (tag, name, err.max().item(), want.abs().max().item()))
            errs[name] = err.max().item()
        log("  %-40s max|d-plain| dq %.3g dk %.3g dv %.3g"
            % (tag, errs["dq"], errs["dk"], errs["dv"]))
        return (q, k, v, o, lse, do, delta, scale,
                max(errs["dk"], errs["dv"]), errs["dq"], err_fwd)

    log("flash_bwd_dkv / flash_bwd_dq vs plain version:")
    for tag, shape, causal, dtype, g in (
            ("fp32 B2 H3 S1000 D64 causal", (2, 3, 1000, 64), True,
             torch.float32, False),
            ("fp16 B1 H4 S300 D128 g_lse", (1, 4, 300, 128), False,
             torch.float16, True),
            ("bf16 B1 H2 S130 D64 causal", (1, 2, 130, 64), True,
             torch.bfloat16, False)):
        compare(tag, *shape, causal, dtype, g)

    out = {"dkv": [], "dq": [], "fwd": []}
    for tag, (B, H, S, D), causal, iters in (
            ("bert", (BERT_TRAIN_B, 8, BERT_S, 128), False, 5),
            ("gpt", (GPT_TRAIN_B, 8, GPT_S, 128), True, 3)):
        shape = "B%d H%d S%d D%d bf16%s" % (B, H, S, D,
                                            " causal" if causal else "")
        (q, k, v, o, lse, do, delta, scale, err_dkv, err_dq,
         err_fwd) = compare("%s %s" % (tag, shape), B, H, S, D, causal,
                            torch.bfloat16, False)
        ms_dkv = timed_ms(lambda: A._flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, causal, scale), iters)
        ms_dq = timed_ms(lambda: A._flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, causal, scale), iters)
        ms_fwd = timed_ms(lambda: A._flash_fwd_cuda(q, k, v, causal, scale),
                          iters)
        plain_fwd_ms = timed_ms(lambda: A._fa_reference(
            q, k, v, causal, scale), 2)
        lib_fwd_ms = timed_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), iters)
        plain_ms = timed_ms(lambda: A._fa_bwd_reference(
            q, k, v, o, lse, do, causal, scale), 2)
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)
        lib_ms = timed_ms(lambda: torch.autograd.grad(
            sdpa, (qr, kr, vr), do, retain_graph=True), iters)
        for kernel, ms, err in (("dkv", ms_dkv, err_dkv),
                                ("dq", ms_dq, err_dq)):
            bound_ms, bound_by = attention_bwd_bound_ms(kernel, B * H, S, D,
                                                        causal, 2)
            out[kernel].append(dict(
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms))
        fwd_bound, fwd_by = attention_bound_ms(B * H, S, D, causal, 2)
        out["fwd"].append(dict(shape=shape, max_abs_err=err_fwd, ms=ms_fwd,
                               plain_ms=plain_fwd_ms, library_ms=lib_fwd_ms,
                               bound_ms=fwd_bound, bound_by=fwd_by))
        log("  %s: K2 %.3f ms  K3 %.3f ms  plain bwd %.3f ms  sdpa bwd %.3f "
            "ms  bound K2 %.4f K3 %.4f ms; K1 %.3f ms  plain fwd %.3f ms  "
            "sdpa fwd %.4f ms  bound %.4f ms"
            % (tag, ms_dkv, ms_dq, plain_ms, lib_ms,
               out["dkv"][-1]["bound_ms"], out["dq"][-1]["bound_ms"],
               ms_fwd, plain_fwd_ms, lib_fwd_ms, fwd_bound))
        del q, k, v, o, lse, do, delta, qr, kr, vr, sdpa
        torch.cuda.empty_cache()
    return out


def _small_pair(kind, seed=1):
    """A small float32 BERT or GPT on the CPU (head width 64, so the
    kernels engage on the card) and its (step net, loss) for training."""
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    kw = dict(vocab_size=1000, units=128, num_layers=2, num_heads=2,
              max_length=256, attention="flash")
    if kind == "bert":
        net = models.BERTModel(hidden_size=512, dropout=0.0, **kw)
    else:
        net = models.GPTModel(**kw)
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    if kind == "bert":
        return net, net, mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    return net, models.FeaturesView(net), models.ChunkedLMLoss(net,
                                                                chunk=128)


def check_small_training_against_cpu():
    """Three Adam TrainSteps of the small fp32 models, on the card (kernel
    route) and on the CPU (plain route), from the same weights: per-step
    losses and the parameters after the steps agree within 1e-3."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.ops import _kernels
    tokens = onp.random.RandomState(2).randint(0, 1000, (2, 256)) \
        .astype("int32")
    for kind in ("bert", "gpt"):
        runs = {}
        for where in ("cpu", "gpu"):
            model, net, loss_fn = _small_pair(kind)
            if where == "gpu":
                model.to("cuda:0")
            step = mxt.jit.TrainStep(net, loss_fn, mxt.gluon.Trainer(
                net.collect_params(), "adam", {"learning_rate": 1e-3}))
            _kernels.reset_launches()
            losses = [step(tokens, tokens).cpu() for _ in range(3)]
            launches = dict(_kernels.LAUNCHES)
            runs[where] = (losses, mxt.to_numpy_params(model))
            check(where == "cpu" or all(
                launches.get(n, 0) == 2 * 3 for n in
                ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")),
                "small %s training launched %s, expected 6 of each kernel"
                % (kind, launches))
        loss_err = max((a - b).abs().max().item()
                       for a, b in zip(runs["cpu"][0], runs["gpu"][0]))
        for a, b in zip(runs["cpu"][0], runs["gpu"][0]):
            check(torch.allclose(a, b, atol=1e-3, rtol=1e-3),
                  "small %s training: losses differ, card %s vs CPU %s"
                  % (kind, b.tolist(), a.tolist()))
        param_err = 0.0
        for name, ref in runs["cpu"][1].items():
            got = runs["gpu"][1][name]
            param_err = max(param_err, float(onp.abs(got - ref).max()))
            check(onp.allclose(got, ref, atol=1e-3, rtol=1e-3),
                  "small %s training: %s differs after 3 steps (max abs "
                  "%.3g)" % (kind, name, onp.abs(got - ref).max()))
        log("small %s fp32 training, card vs CPU: losses %s, max abs diff "
            "loss %.3g params %.3g" % (kind, [round(float(x.mean()), 5)
                                              for x in runs["gpu"][0]],
                                       loss_err, param_err))


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
    check(launches.get("flash_bwd_dkv", 0) == 0
          and launches.get("flash_bwd_dq", 0) == 0,
          "the backward kernels launched on the serving path: %s" % launches)
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


def train_full_width(bwd):
    """The training path at full width; returns (launches by model,
    summary). ``bwd`` is check_flash_bwd's result: the kernels' ms at the
    training shapes, for their share of a step."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import models
    from incubator_mxnet_tpu_torch.ops import _kernels

    dev = torch.device("cuda", 0)
    rng = onp.random.RandomState(3)
    launches_by_model, summary = {}, {}
    for i, (name, cfg, B, S, (warm, timed)) in enumerate((
            ("bert", BERT, BERT_TRAIN_B, BERT_S, BERT_TRAIN_STEPS),
            ("gpt", GPT, GPT_TRAIN_B, GPT_S, GPT_TRAIN_STEPS))):
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(i)
        model = (models.BERTModel if name == "bert" else models.GPTModel)(
            **cfg)
        model.initialize(mxt.init.Xavier(), ctx=mxt.gpu(0), generator=gen)
        model.cast("bfloat16")
        if name == "bert":
            net, loss_fn = model, mxt.gluon.loss.SoftmaxCrossEntropyLoss()
        else:
            net, loss_fn = models.FeaturesView(model), \
                models.ChunkedLMLoss(model)
        trainer = mxt.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 1e-4,
                                     "multi_precision": True})
        step = mxt.jit.TrainStep(net, loss_fn, trainer)
        tokens = torch.from_numpy(rng.randint(0, cfg["vocab_size"], (B, S))
                                  .astype("int32")).to(dev)
        n_params = sum(p.data().numel()
                       for p in net.collect_params().values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0

        losses = [step(tokens, tokens)]
        phases = step_phases(step, tokens)     # the second warm-up step
        losses.append(phases.pop("loss"))
        for _ in range(warm - 2):
            losses.append(step(tokens, tokens))
        torch.cuda.synchronize()
        _kernels.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        for _ in range(timed):
            losses.append(step(tokens, tokens))
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - h0) * 1e3 / timed
        step_ms = start.elapsed_time(end) / timed
        launches = dict(_kernels.LAUNCHES)
        launches_by_model[name] = launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        means = [float(l.float().mean()) for l in losses]
        check(all(onp.isfinite(means)) and all(
            bool(torch.isfinite(l.float()).all()) for l in losses),
              "%s training: a loss is not finite: %s" % (name, means))
        check(means[-1] < means[0], "%s training: loss did not fall: %s"
              % (name, means))
        expected = cfg["num_layers"] * timed
        for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
            check(launches.get(k, 0) == expected,
                  "%s training: %s launched %d times over %d timed steps, "
                  "expected %d layers x %d" % (name, k, launches.get(k, 0),
                                               timed, cfg["num_layers"],
                                               timed))
        for j, p in enumerate(trainer._params):
            w = p.data()
            check(bool(torch.isfinite(w.float()).all()),
                  "%s training: parameter %d is not finite" % (name, j))
            check(w.dtype == torch.bfloat16 and torch.equal(
                w, trainer._states[j][0].to(torch.bfloat16)),
                "%s training: parameter %d is not its fp32 master cast to "
                "bf16" % (name, j))

        shape_i = 0 if name == "bert" else 1
        kernel_ms = {k: bwd[key][shape_i]["ms"] for k, key in (
            ("flash_fwd", "fwd"), ("flash_bwd_dkv", "dkv"),
            ("flash_bwd_dq", "dq"))}
        attn_ms = sum(kernel_ms[k] * launches[k] for k in kernel_ms) / timed
        row = dict(
            batch=[B, S], params=n_params, warmup_steps=warm,
            timed_steps=timed, step_ms=step_ms, step_host_ms=host_ms,
            tokens_per_s=B * S / (step_ms / 1e3), peak_memory_gb=peak_gb,
            losses=means, setup_s=setup_s, launches=launches,
            attention_kernels_ms_per_step=attn_ms,
            attention_kernels_share=attn_ms / step_ms,
            warm_step_phases_ms=phases)
        if name == "bert":
            flops = 6.0 * n_params * B * S \
                + cfg["num_layers"] * 12.0 * B * S * S * cfg["units"]
            row["share_of_989_tflops"] = flops / (step_ms / 1e3) \
                / PEAK_BF16_FLOPS
        summary[name] = row
        log("training %s: %d params, B %d x S %d; step %.1f ms (host %.1f); "
            "%.0f tokens/s; peak memory %.2f GB; losses %.4f -> %.4f; warm "
            "step fwd %.1f / bwd %.1f / update %.1f ms; K1+K2+K3 %.1f ms "
            "per step (%.0f%%)%s"
            % (name, n_params, B, S, step_ms, host_ms, row["tokens_per_s"],
               peak_gb, means[0], means[-1], phases["forward_ms"],
               phases["backward_ms"], phases["update_ms"], attn_ms,
               100 * row["attention_kernels_share"],
               "; %.1f%% of 989 TFLOP/s" % (100 * row["share_of_989_tflops"])
               if name == "bert" else ""))
        del model, net, loss_fn, trainer, step, tokens, losses
        gc.collect()
        torch.cuda.empty_cache()
    return launches_by_model, summary


def step_phases(step, tokens):
    """One TrainStep, phase by phase as TrainStep.__call__ runs them, with
    CUDA events between: forward (with the loss), backward, update."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    args = step._prepare((tokens, tokens), 1)
    ev[0].record()
    loss = step._forward(args, 1)
    ev[1].record()
    step._backward(loss)
    ev[2].record()
    step._update(args[0].shape[0])
    ev[3].record()
    ev[3].synchronize()
    return dict(forward_ms=ev[0].elapsed_time(ev[1]),
                backward_ms=ev[1].elapsed_time(ev[2]),
                update_ms=ev[2].elapsed_time(ev[3]), loss=loss.detach())


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
        bwd = check_flash_bwd()
        check_small_models_against_cpu()
        check_small_training_against_cpu()
        serve_launches, serving = serve_full_width()
        gc.collect()
        torch.cuda.empty_cache()
        train_launches, training = train_full_width(bwd)
    except SmokeFailure as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        return 1
    src = "incubator_mxnet_tpu_torch/ops/csrc/"
    # the GPT training shape is the served GPT shape: listed once
    fwd_shapes = served + bwd["fwd"][:1]
    by_path = {k: {"serving": serve_launches.get(k, 0),
                   **{"training_" + m: train_launches[m].get(k, 0)
                      for m in train_launches}}
               for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    kernels = [dict(
        name="flash_fwd", route="cuda", source=src + "flash_fwd.cu",
        replaces="incubator_mxnet_tpu/ops/attention.py:103",
        launches=sum(by_path["flash_fwd"].values()),
        launches_by_path=by_path["flash_fwd"],
        max_abs_err=max(s["max_abs_err"] for s in fwd_shapes),
        ms=sum(s["ms"] for s in fwd_shapes),
        plain_ms=sum(s["plain_ms"] for s in fwd_shapes),
        bound_ms=sum(s["bound_ms"] for s in fwd_shapes),
        bound_by=max(fwd_shapes, key=lambda s: s["bound_ms"])["bound_by"],
        library_ms=sum(s["library_ms"] for s in fwd_shapes),
        note="ms/plain_ms/bound_ms/library_ms: one launch at each shape of "
             "the serving and training paths, summed; per shape in "
             "'shapes' (served BERT, GPT, then BERT training; GPT training "
             "is the served GPT shape)",
        shapes=fwd_shapes)]
    for name, key, line in (("flash_bwd_dkv", "dkv", 223),
                            ("flash_bwd_dq", "dq", 248)):
        rows = bwd[key]
        kernels.append(dict(
            name=name, route="cuda", source=src + "flash_bwd.cu",
            replaces="incubator_mxnet_tpu/ops/attention.py:%d" % line,
            launches=sum(by_path[name].values()),
            launches_by_path=by_path[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=sum(r["library_ms"] for r in rows),
            note="one launch at each training shape, summed; per shape in "
                 "'shapes'. plain_ms is the whole plain backward "
                 "(_fa_bwd_reference: dQ, dK and dV) and library_ms the "
                 "backward of scaled_dot_product_attention, which also "
                 "computes all three: both are the pair K2 + K3's",
            shapes=rows))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"training": training}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
