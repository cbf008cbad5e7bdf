"""The port's runtime kernels (``rtc.py``, K5): MXNet's NVRTC ``CudaModule``
and a Triton module in the role of the JAX package's ``PallasModule``.

K5 has no plain version of its own (the user supplies the kernel) and no
CPU route, so what runs here is the host side: signature parsing and the
argument checks a launch makes before anything is compiled or launched.
The ``cuda``-marked tests compile and launch sample kernels on the card and
hold them against torch; they skip here, and ``chip_smoke.py`` runs the same
samples on the card.

The launch path itself (argument slots, the context check, the shared
memory attribute, the half conversion, the stream) is tested here against a
stand-in for ``libcuda`` that records the CUDA driver calls a launch
makes.
"""
import ctypes
import math
import threading

import pytest
import torch
from hypothesis import given, settings, strategies as st

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import rtc
from incubator_mxnet_tpu_torch.ops import _kernels

AXPY = r'''
extern "C" __global__ void axpy(const float *x, float *y, float a, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] += a * x[i];
}
template <typename T>
__global__ void scale(T *x, T a, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) x[i] *= a;
}
'''
BLOCK_SUM = r'''
extern "C" __global__ void block_sum(const float *x, float *out, int n) {
  extern __shared__ float sh[];
  float s = 0.f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    s += x[i];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int k = blockDim.x / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) sh[threadIdx.x] += sh[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = sh[0];
}
'''


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: rtc compiles and launches CUDA "
                    "kernels and has no CPU route")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("signature,want", [
    ("const float *x, float *y, int n",
     [("x", "float", True, True), ("y", "float", True, False),
      ("n", "int", False, False)]),
    ("const __half* a, int64_t n, uint8_t *mask, double s, int32_t k",
     [("a", "__half", True, True), ("n", "int64_t", False, False),
      ("mask", "uint8_t", True, False), ("s", "double", False, False),
      ("k", "int32_t", False, False)]),
    ("", []),
])
def test_signature_parsing(signature, want):
    assert rtc._parse_signature(signature) == want


@pytest.mark.parametrize("signature", ["const float *x, bool flag",
                                       "float **x", "int n m"])
def test_signature_refuses_what_it_does_not_take(signature):
    with pytest.raises(ValueError):
        rtc._parse_signature(signature)


def test_launch_arguments_are_checked_against_the_signature():
    params = rtc._parse_signature("const float *x, float *y, float a, int n")
    dev = torch.device("cuda", 0)
    x = torch.zeros(4)
    with pytest.raises(TypeError, match="must be torch.float32"):
        rtc._ArgLayout(params).fill([x.double(), x, 1.0, 4], dev)
    with pytest.raises(ValueError, match="lies on cpu"):
        rtc._ArgLayout(params).fill([x, x, 1.0, 4], dev)
    with pytest.raises(TypeError, match="pass a tensor"):
        rtc._ArgLayout(params).fill([1.0, x, 1.0, 4], dev)
    with pytest.raises(TypeError, match="scalar"):
        rtc._ArgLayout(params[2:]).fill([x, 4], dev)
    with pytest.raises(ValueError, match="takes 4 arguments"):
        rtc._ArgLayout(params).fill([x, x], dev)
    half = rtc._ArgLayout(rtc._parse_signature("__half a, int64_t n")).fill(
        [1.5, 2 ** 40], dev)
    assert half[0].value == 0x3E00 and half[1].value == 2 ** 40
    assert isinstance(half[1], ctypes.c_int64)


def test_launch_refuses_a_cpu_context():
    kernel = rtc.CudaKernel(None, "axpy", "const float *x, float *y, "
                            "float a, int n")
    x = torch.zeros(4)
    for ctx in (mxt.cpu(), "cpu", torch.device("cpu")):
        with pytest.raises(ValueError, match="GPU context"):
            kernel.launch([x, x, 1.0, 4], ctx, (1,), (4,))
    assert _kernels.LAUNCHES.get("rtc", 0) == 0


def test_cuda_module_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the module compiles")
    with pytest.raises(RuntimeError, match="CUDA"):
        rtc.CudaModule(AXPY)


def test_triton_module_without_triton_raises_a_clear_error():
    try:
        import triton  # noqa: F401
        pytest.skip("triton is installed")
    except ImportError:
        pass
    kernel = rtc.TritonModule(lambda *a: None).get_kernel()
    with pytest.raises(RuntimeError, match="needs the triton package"):
        kernel.launch([torch.zeros(4)], "cpu", (1,))


PRIMARY, OTHER = 0x5000, 0x6000     # context handles of the stand-in


class FakeCuda:
    """``libcuda`` as a launch calls it: device 0's primary context is
    ``PRIMARY``, ``current`` is what ``cuCtxGetCurrent`` reports, and
    ``calls`` records pushes, pops, attributes and launches (with the
    argument values read back through the ``void*[]`` array)."""

    def __init__(self, current=PRIMARY, launch_error=0):
        self.current = current
        self.launch_error = launch_error
        self.calls = []

    def cuDeviceGet(self, ref, index):
        ref._obj.value = index
        return 0

    def cuDevicePrimaryCtxRetain(self, ref, dev):
        ref._obj.value = PRIMARY
        return 0

    def cuCtxGetCurrent(self, out):
        out.value = self.current
        return 0

    def cuCtxPushCurrent_v2(self, ctx):
        self.calls.append(("push", ctx))
        return 0

    def cuCtxPopCurrent_v2(self, out):
        self.calls.append(("pop",))
        return 0

    def cuModuleLoadData(self, ref, image):
        self.calls.append(("load",))
        ref._obj.value = 0x1000
        return 0

    def cuModuleGetFunction(self, ref, mod, name):
        ref._obj.value = 0x2000
        return 0

    def cuFuncSetAttribute(self, fn, attr, value):
        self.calls.append(("attr", fn, attr, value))
        return 0

    def cuLaunchKernel(self, fn, gx, gy, gz, bx, by, bz, shared, stream,
                       params, extra):
        n = ctypes.cast(params[0], ctypes.POINTER(ctypes.c_int32))[0]
        h = ctypes.cast(params[1], ctypes.POINTER(ctypes.c_uint16))[0]
        self.calls.append(("launch", fn, (gx, gy, gz), (bx, by, bz), shared,
                           stream, ctypes.addressof(params), n, h))
        return self.launch_error

    def cuGetErrorString(self, err, ref):
        ref._obj.value = b"fake error"
        return 0


@pytest.fixture
def fake_cuda(monkeypatch):
    """A ``CudaKernel`` "k(int n, __half h)" of a module loaded nowhere yet,
    launched against ``FakeCuda`` on cuda:0's stream 0x77."""
    fake = FakeCuda()
    monkeypatch.setitem(rtc._libs, "cuda", fake)
    monkeypatch.setattr(rtc, "_contexts", {})
    monkeypatch.setattr(_kernels, "stream", lambda where: 0x77)
    mod = object.__new__(rtc.CudaModule)
    mod._cubin, mod._lowered, mod._loaded, mod._functions = b"\0", {}, {}, {}
    _kernels.reset_launches()
    return fake, mod, torch.device("cuda", 0)


def _launches(fake):
    return [c for c in fake.calls if c[0] == "launch"]


def test_launch_writes_the_arguments_into_the_same_slots(fake_cuda):
    fake, mod, dev = fake_cuda
    kernel = mod.get_kernel("k", "int n, __half h")
    kernel.launch([7, 1.5], dev, (3,), (128, 2))
    kernel.launch([9, -2.0], dev, 4, (64,), 0)
    kernel.launch([5, 0.5], dev, (4,), 64)
    first, second, third = _launches(fake)
    assert first[1:6] == (0x2000, (3, 1, 1), (128, 2, 1), 0, 0x77)
    assert second[1:6] == third[1:6] == (0x2000, (4, 1, 1), (64, 1, 1), 0,
                                         0x77)
    assert (first[7:], second[7:], third[7:]) == ((7, 0x3E00), (9, 0xC000),
                                                  (5, 0x3800))
    assert first[6] == second[6] == third[6] == ctypes.addressof(
        kernel._layout.array)
    assert [c for c in fake.calls if c[0] == "load"] == [("load",)]
    assert _kernels.LAUNCHES["rtc"] == 3


def test_argument_slots_are_made_once_and_reused():
    layout = rtc._ArgLayout(rtc._parse_signature(
        "const float *x, float *y, float a, int n"))
    slots = list(layout.slots)
    cpu = torch.device("cpu")
    x, y = torch.zeros(4), torch.ones(8)
    for args in ([x, y, 2.5, 4], [y, x, -1.0, 8]):
        got = layout.fill(args, cpu)
        assert all(a is b for a, b in zip(got, slots))
        assert [layout.array[i] for i in range(4)] == [
            ctypes.addressof(s) for s in slots]
        assert (slots[0].value, slots[1].value) == (args[0].data_ptr(),
                                                    args[1].data_ptr())
        assert slots[2].value == args[2] and slots[3].value == args[3]


def test_shared_memory_attribute_is_set_only_when_the_size_grows(fake_cuda):
    fake, mod, dev = fake_cuda
    kernel = mod.get_kernel("k", "int n, __half h")
    for shared in (0, 48 * 1024, 64 * 1024, 64 * 1024, 32 * 1024,
                   100 * 1024, 64 * 1024):
        kernel.launch([1, 0.0], dev, (1,), (32,), shared)
    # a second kernel object of the same function shares its attribute
    mod.get_kernel("k", "int n, __half h").launch([1, 0.0], dev, (1,), (32,),
                                                  80 * 1024)
    attrs = [c for c in fake.calls if c[0] == "attr"]
    assert attrs == [("attr", 0x2000, rtc._MAX_DYNAMIC_SHARED, 64 * 1024),
                     ("attr", 0x2000, rtc._MAX_DYNAMIC_SHARED, 100 * 1024)]
    assert [c[4] for c in _launches(fake)] == [
        0, 48 * 1024, 64 * 1024, 64 * 1024, 32 * 1024, 100 * 1024,
        64 * 1024, 80 * 1024]


@pytest.mark.parametrize("current,pushed", [(PRIMARY, False), (OTHER, True),
                                            (None, True)])
def test_context_is_pushed_only_when_another_is_current(fake_cuda, current,
                                                        pushed):
    fake, mod, dev = fake_cuda
    kernel = mod.get_kernel("k", "int n, __half h")
    kernel.launch([1, 0.0], dev, (1,), (32,))      # loads the module
    fake.calls.clear()
    fake.current = current
    kernel.launch([1, 0.0], dev, (1,), (32,), 64 * 1024)
    names = [c[0] for c in fake.calls]
    if pushed:
        assert names == ["push", "attr", "launch", "pop"]
        assert fake.calls[0] == ("push", PRIMARY)
    else:
        assert names == ["attr", "launch"]


def test_a_failed_launch_raises_and_is_not_counted(fake_cuda):
    fake, mod, dev = fake_cuda
    fake.current, fake.launch_error = OTHER, 700
    kernel = mod.get_kernel("k", "int n, __half h")
    with pytest.raises(RuntimeError, match=r"cuLaunchKernel\(k\) failed: "
                       r"fake error \(CUresult 700\)"):
        kernel.launch([1, 0.0], dev, (1,), (32,))
    assert fake.calls[-1] == ("pop",)
    assert _kernels.LAUNCHES.get("rtc", 0) == 0


def test_a_wrong_argument_raises_before_libcuda_is_called(fake_cuda):
    fake, mod, dev = fake_cuda
    kernel = mod.get_kernel("k", "int n, __half h")
    with pytest.raises(TypeError, match="scalar, got a tensor"):
        kernel.launch([torch.zeros(1), 0.0], dev, (1,), (32,))
    with pytest.raises(ValueError, match="takes 2 arguments"):
        kernel.launch([1], dev, (1,), (32,))
    assert fake.calls == [] and _kernels.LAUNCHES.get("rtc", 0) == 0


class _OnCuda3(torch.Tensor):
    """A CPU tensor that names cuda:3 as its device."""

    @property
    def device(self):
        return torch.device("cuda", 3)


@pytest.mark.parametrize("where", ["tensor", "device"])
def test_the_stream_is_that_of_the_tensors_device(monkeypatch, where):
    """The raw stream of the device the tensor (or device) names, never of
    the thread's current device: a backward runs on autograd's thread."""
    asked = []
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: asked.append(index) or 0x900 + index,
                        raising=False)
    arg = torch.device("cuda", 3) if where == "device" \
        else torch.empty(0).as_subclass(_OnCuda3)
    assert _kernels.stream(arg) == 0x903 and asked == [3]


def test_a_gpu_context_is_resolved_once(monkeypatch):
    from incubator_mxnet_tpu_torch import context
    looked = []
    monkeypatch.setattr(rtc, "_resolved", {})
    monkeypatch.setattr(context, "num_gpus", lambda: looked.append(1) or 1)
    for ctx in (mxt.gpu(0), mxt.gpu(0), "cuda:0", "cuda:0",
                torch.device("cuda", 0)):
        assert rtc._cuda_device(ctx) == torch.device("cuda", 0)
    assert looked == [1]
    assert set(rtc._resolved) == {mxt.gpu(0), "cuda:0",
                                  torch.device("cuda", 0)}


def _torch_half_bits(x):
    return int(torch.tensor(float(x), dtype=torch.float16)
               .view(torch.int16).item()) & 0xFFFF


@pytest.mark.parametrize("x", [
    0.0, -0.0, 1.0, -2.5, 0.1, 1 / 3, 65504.0, -65504.0, 65519.0, 65519.999,
    65520.0, 1e5, -1e300, 3.5e38, 1e39, math.inf, -math.inf, math.nan,
    2.0 ** -14, 2.0 ** -24, 1.5 * 2.0 ** -24, 2.0 ** -25, 2.0 ** -26,
    -3 * 2.0 ** -20, 6.1e-5, 1 + 2.0 ** -11, 1 + 2.0 ** -11 + 2.0 ** -40,
    5, -7, 2 ** 20])
def test_half_bits_equal_torchs_conversion(x):
    assert rtc._half_bits(x) == _torch_half_bits(x)


@settings(max_examples=300, deadline=None)
@given(st.floats(allow_nan=True, allow_infinity=True)
       | st.floats(min_value=-7e4, max_value=7e4)
       | st.floats(min_value=-1e-4, max_value=1e-4))
def test_half_bits_equal_torchs_conversion_swept(x):
    assert rtc._half_bits(x) == _torch_half_bits(x)


@pytest.mark.cuda
def test_axpy_and_exported_template_on_the_card(cuda_device):
    mod = rtc.CudaModule(AXPY, exports=("scale<float>",))
    n = 100003
    x = torch.randn(n, device=cuda_device)
    y = torch.randn(n, device=cuda_device)
    want = y + 2.5 * x
    _kernels.reset_launches()
    mod.get_kernel("axpy", "const float *x, float *y, float a, int n") \
        .launch([x, y, 2.5, n], mxt.gpu(0), ((n + 255) // 256,), (256,))
    mod.get_kernel("scale<float>", "float *x, float a, int64_t n") \
        .launch([y, 0.5, n], cuda_device, ((n + 255) // 256,), (256,))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["rtc"] == 2
    torch.testing.assert_close(y, want * 0.5, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
def test_block_reduction_through_shared_memory_on_the_card(cuda_device):
    mod = rtc.CudaModule(BLOCK_SUM)
    x = torch.randn(1 << 20, device=cuda_device)
    out = torch.empty(120, device=cuda_device)
    mod.get_kernel("block_sum", "const float *x, float *out, int n") \
        .launch([x, out, x.numel()], "cuda:0", (120,), (512,), 512 * 4)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.sum(), x.sum(), atol=1e-2, rtol=1e-5)


@pytest.mark.cuda
def test_compile_error_raises_with_the_log(cuda_device):
    with pytest.raises(RuntimeError, match="NVRTC compile failed"):
        rtc.CudaModule('extern "C" __global__ void k() { undefined_x = 1; }')


@pytest.mark.cuda
def test_a_larger_shared_memory_launch_after_a_smaller_one(cuda_device):
    mod = rtc.CudaModule(BLOCK_SUM)
    kernel = mod.get_kernel("block_sum", "const float *x, float *out, int n")
    x = torch.randn(1 << 20, device=cuda_device)
    for shared in (512 * 4, 64 * 1024, 160 * 1024):
        out = torch.empty(120, device=cuda_device)
        kernel.launch([x, out, x.numel()], cuda_device, (120,), (512,),
                      shared)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.sum(), x.sum(), atol=1e-2, rtol=1e-5)


@pytest.mark.parametrize("where", ["this thread", "another device"])
@pytest.mark.cuda
def test_a_launch_lands_on_its_devices_current_stream(cuda_device, where):
    """Captured into a CUDA graph on cuda:0's current stream, from this
    thread or with cuda:1 current (its context pushed over): the launch is
    recorded, not run, and runs at the replay."""
    if where == "another device" and torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    mod = rtc.CudaModule(AXPY)
    kernel = mod.get_kernel("axpy", "const float *x, float *y, float a, "
                            "int n")
    n = 4096
    x = torch.randn(n, device=cuda_device)
    y = torch.zeros(n, device=cuda_device)
    kernel.launch([x, y, 1.0, n], cuda_device, (n // 256,), (256,))
    torch.cuda.synchronize()
    y.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        if where == "this thread":
            kernel.launch([x, y, 1.0, n], "cuda:0", (n // 256,), (256,))
        else:
            with torch.cuda.device(1):
                kernel.launch([x, y, 1.0, n], "cuda:0", (n // 256,), (256,))
    torch.cuda.synchronize()
    assert float(y.abs().max()) == 0.0
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(y, x)


@pytest.mark.cuda
def test_a_launch_from_a_thread_with_no_current_context(cuda_device):
    """A new thread has no CUDA context current until something makes one
    current: the launch pushes cuda:0's primary context and pops it."""
    mod = rtc.CudaModule(AXPY)
    kernel = mod.get_kernel("axpy", "const float *x, float *y, float a, "
                            "int n")
    n = 100003
    x = torch.randn(n, device=cuda_device)
    y = torch.zeros(n, device=cuda_device)
    torch.cuda.synchronize()
    seen, errors = [], []

    def launch():
        try:
            lib = rtc._libcuda()
            current = ctypes.c_void_p()
            lib.cuCtxGetCurrent(current)
            seen.append(current.value)
            kernel.launch([x, y, 2.0, n], "cuda:0", (-(-n // 256),), (256,))
            lib.cuCtxGetCurrent(current)
            seen.append(current.value)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    t = threading.Thread(target=launch)
    t.start()
    t.join(60)
    assert not t.is_alive() and not errors, errors
    assert seen == [None, None]
    torch.cuda.synchronize()
    torch.testing.assert_close(y, 2.0 * x)


@pytest.mark.cuda
def test_triton_launches_after_the_first_on_new_inputs(cuda_device):
    """The launches after a specialization's first, on new tensors, and a
    launch with another ``constexpr``: each output exact."""
    pytest.importorskip("triton")
    import triton
    import triton.language as tl

    @triton.jit
    def add(a, b, n, out, BLOCK: tl.constexpr):
        i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = i < n
        tl.store(out + i, tl.load(a + i, mask=mask) + tl.load(b + i, mask=mask),
                 mask=mask)

    kernel = rtc.TritonModule(add).get_kernel()
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    n = 100003
    _kernels.reset_launches()
    for block in (1024, 1024, 1024, 256):
        a = torch.randn(n, generator=gen, device=cuda_device)
        b = torch.randn(n, generator=gen, device=cuda_device)
        out = kernel.launch([a, b, n], cuda_device, (-(-n // block),),
                            BLOCK=block)
        torch.cuda.synchronize()
        assert torch.equal(out, a + b)
    assert _kernels.LAUNCHES["rtc_triton"] == 4
