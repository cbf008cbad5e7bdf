"""Large-tensor (int64, >2^31 elements) support of the port, the JAX
package's tests/test_large_tensor.py run against it (ref
tests/nightly/test_large_array.py / test_large_vector.py, gated by
USE_INT64_TENSOR_SIZE in the reference build).

Torch sizes and indices are int64 end to end, so >2^31-element arrays need
no special build flag; this test shows it on the CPU. Gated like the
reference's nightly (a 2.5 GB host allocation): MXTPU_TEST_LARGE_TENSOR=1
enables it (the port's registry declares the knob), and a free-memory
check skips it otherwise.
"""
import pytest

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import nd

N = 2 ** 31 + 4096  # past the int32 element-count boundary
CPU = mxt.cpu()


def _enabled():
    from incubator_mxnet_tpu_torch.config import get_env
    if not get_env("MXTPU_TEST_LARGE_TENSOR"):
        return False
    try:
        avail = int(next(l for l in open("/proc/meminfo")
                         if l.startswith("MemAvailable")).split()[1]) * 1024
    except Exception:
        return True
    return avail > 6 * 2 ** 30


@pytest.mark.skipif(not _enabled(),
                    reason="set MXTPU_TEST_LARGE_TENSOR=1 (needs ~6GB free)")
def test_large_vector_int64_indexing():
    x = nd.zeros((N,), dtype="uint8", ctx=CPU)
    assert x.size == N  # python int — no int32 wrap
    assert int(nd.size_array(x).asnumpy()[0]) == N  # int64 size op
    # write + read back across the 2^31 boundary
    x[N - 3] = 7
    x[2 ** 31 + 1] = 9
    assert int(x[N - 3].asnumpy()) == 7
    assert int(x[2 ** 31 + 1].asnumpy()) == 9
    # reductions walk all int64-indexed elements
    assert int(x.sum().asnumpy()) == 16
    assert int(nd.argmax(x, axis=0).asnumpy()) == 2 ** 31 + 1
    # slicing past the boundary keeps values
    tail = x[N - 8:].asnumpy()
    assert tail.shape == (8,) and tail[-3] == 7


@pytest.mark.skipif(not _enabled(),
                    reason="set MXTPU_TEST_LARGE_TENSOR=1 (needs ~6GB free)")
def test_large_matrix_rows_past_int32():
    # 2D shape whose element COUNT crosses 2^31 (rows stay modest)
    rows, cols = 2 ** 16 + 8, 2 ** 15 + 4
    x = nd.zeros((rows, cols), dtype="uint8", ctx=CPU)
    assert x.size == rows * cols > 2 ** 31
    x[rows - 1, cols - 1] = 5
    assert int(x[rows - 1, cols - 1].asnumpy()) == 5
    s = nd.sum(x, axis=1)
    assert s.shape == (rows,)
    assert int(s[rows - 1].asnumpy()) == 5
