"""Model deployment export (counterpart of ``incubator_mxnet_tpu/contrib/
serving.py``; MXNet's ``c_predict_api.cc`` role).

The JAX package's deployment artifact is its forward with the parameters
baked in, serialized by ``jax.export``. The port's is the same forward
exported by ``torch.export`` (``jit.export_forward(..., baked=True)``),
parameters included, written after an 8-byte magic as
``torch.export.save`` writes it. ``load`` reads it back in any process
with torch (it registers K1's ``mxtpu::flash_fwd`` operator first), and
``ServedModel`` serves it: one program per (input signature, device) in
``aot.CACHE``, captured as a CUDA graph over the program's own baked
tensors on the card and run as it is on the CPU.

Departures (ROADMAP §3): ``export_mlir`` returns the exported program's
text, not StableHLO (there is none); ``export_pjrt_bundle`` raises: a
Python-free loader is the last piece of ROADMAP §1 item 8 (the C ABI of
``native/``, libmxtpu_predict, loads these artifacts through an embedded
interpreter).
A ServedModel computes on the device its program was exported on: every
batcher replica dispatches there.
"""
from __future__ import annotations

import hashlib
import threading

import numpy as onp
import torch

from .. import aot
from .. import jit
from ..ndarray import NDArray
from ..telemetry import numwatch

__all__ = ["export_model", "load", "export_mlir", "export_pjrt_bundle",
           "ServedModel"]

#: the port's artifact magic: another payload than the JAX package's
#: ``MXTPU\x00v1`` (jax.export bytes), so neither package misreads the
#: other's file
_MAGIC = b"MXTPU\x00t1"


def _tensor(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(onp.asarray(x))


def export_model(net, example_inputs, path, train_mode=False):
    """Serialize ``net``'s forward (parameters baked in) to ``path`` at the
    signature of ``example_inputs`` (NDArrays, tensors or numpy arrays on
    the net's device). Returns the ServedModel for immediate use.
    ``train_mode`` is the JAX package's and must stay False: a deployed
    program is an inference program."""
    if train_mode:
        raise ValueError("export_model exports the inference forward; "
                         "train_mode=True has no deployment program")
    if not isinstance(example_inputs, (list, tuple)):
        example_inputs = [example_inputs]
    from ..jit import net_device
    device = net_device(net)
    args = [_tensor(x).to(device) for x in example_inputs]
    program = jit.export_forward(net, args, baked=True)
    payload = aot.serialize_program(program)
    with open(path, "wb") as f:
        f.write(_MAGIC + payload)
    return ServedModel(program, _model_id(payload))


def _model_id(payload):
    return "x" + hashlib.sha256(payload).hexdigest()[:20]


def load(path):
    """Load a ``.mxtpu`` artifact as a ServedModel (MXPredCreate)."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_MAGIC):
        raise ValueError("%s is not an mxtpu serving artifact of the torch "
                         "port" % path)
    payload = buf[len(_MAGIC):]
    return ServedModel(aot.deserialize_program(payload), _model_id(payload))


def export_mlir(path):
    """The artifact's program text. The JAX package returns its StableHLO
    module; a ``torch.export`` program has none, so this is the exported
    graph's printed form (a departure, ROADMAP §3)."""
    return load(path).mlir_module()


def export_pjrt_bundle(artifact_path, out_dir):
    """The JAX package's Python-free serving bundle for its PJRT C loader.
    The port's counterpart is the last piece of ROADMAP §1 item 8; its C
    ABI (libmxtpu_predict) loads ``.mxtpu`` artifacts through an embedded
    interpreter meanwhile."""
    raise NotImplementedError(
        "export_pjrt_bundle: a Python-free loader of the port's artifacts "
        "is the last piece of ROADMAP §1 item 8 (libmxtpu_predict loads "
        "them through an embedded interpreter)")


class ServedModel:
    """The reference's PredictorHandle over an exported program: dispatch
    goes through the process-wide ``aot.CACHE``, one program per input
    signature and device, so two ServedModels loaded from one artifact
    (one digest of its bytes, the model id) share their graphs."""

    def __init__(self, exported, model_id=None):
        program = self._program = exported
        if model_id is None:
            model_id = _model_id(aot.serialize_program(program))
        self._model_id = model_id
        self._module = program.module()
        self._tensors = [t.detach() for t in
                         list(self._module.parameters())
                         + list(self._module.buffers())]
        nodes = {n.name: n for n in program.graph.nodes}
        sig = program.graph_signature
        self._in = [nodes[n].meta["val"] for n in sig.user_inputs]
        out_node = next(n for n in program.graph.nodes if n.op == "output")
        self._out = [a.meta["val"] for a in out_node.args[0]
                     if hasattr(a, "meta")][:len(sig.user_outputs)]
        self._device = (self._tensors[0].device if self._tensors
                        else self._in[0].device)
        self._owner = object()
        self._keys = set()
        self._keys_lock = threading.Lock()

    @property
    def device(self):
        """The device the program computes on (where it was exported)."""
        return self._device

    def _run(self, *datas, replica=0):
        """One execution at the exact signature of ``datas`` (tensors):
        the cached program's replay (captured on its first call, which
        answers eagerly). ``replica`` is accepted: every replica
        dispatches on the program's device."""
        args = [d.to(self._device) for d in datas]
        key = aot.cache_key(self._model_id, aot.input_signature(args),
                            kind="serve", extra=(str(self._device),))
        with self._keys_lock:
            self._keys.add(key)
        first = []
        graphs = jit._uses_graphs(self._device)

        def body(*static):
            out = self._module(*static)
            return list(out) if isinstance(out, (tuple, list)) else [out]

        def build():
            if graphs:
                captured, out = jit._capture(body, args, "serve",
                                             tensors=self._tensors)
            else:
                captured = jit._Direct(body)
                out, captured.stats = jit.devstats.measure(
                    lambda: body(*args))
            first.append(out)
            return captured, None, None
        entry = aot.compile_cached(key, build, owner=self._owner)
        if first:
            return first[0]
        with entry.fn.lock:
            return jit.run_program(entry.fn, args, entry.stats, "serve",
                                   self._model_id)

    @property
    def input_shapes(self):
        return [tuple(v.shape) for v in self._in]

    @property
    def output_shapes(self):
        return [tuple(v.shape) for v in self._out]

    def mlir_module(self):
        """The exported program's text (the JAX package's StableHLO)."""
        return str(self._program)

    def predict(self, *inputs):
        """MXPredSetInput + MXPredForward + MXPredGetOutput: NDArrays on the
        program's device."""
        out = self._run(*[_tensor(x) for x in inputs])
        if len(out) == 1:
            return NDArray(out[0])
        return tuple(NDArray(o) for o in out)

    @property
    def batch_size(self):
        """The exported batch-axis extent (dim 0 of the first input)."""
        shp = self.input_shapes[0]
        if not shp:
            raise ValueError("exported model has a rank-0 input: no batch "
                             "axis to serve over")
        return int(shp[0])

    def predict_batch(self, *stacked_inputs, replica=0):
        """The batcher's entry point: ``n`` stacked items (dim 0) through
        the fixed exported batch ``B``, in ceil(n/B) chunks, the last one
        padded by repeating its final row; the outputs come back as numpy
        arrays (bfloat16 widened to float32) with the padding dropped."""
        from ..serving.registry import _to_host
        B = self.batch_size
        ins = [onp.asarray(x._data.cpu() if isinstance(x, NDArray) else x)
               for x in stacked_inputs]
        ins = [torch.as_tensor(x).to(v.dtype) for x, v in zip(ins, self._in)]
        n = ins[0].shape[0]
        chunks = []
        for lo in range(0, n, B):
            chunk = [x[lo:lo + B] for x in ins]
            pad = B - chunk[0].shape[0]
            if pad:
                chunk = [torch.cat([c, c[-1:].expand(pad, *c.shape[1:])])
                         for c in chunk]
            outs = self._run(*chunk, replica=replica)
            numwatch.device_tap(outs)
            chunks.append([_to_host(o)[:B - pad] for o in outs])
        return tuple(onp.concatenate([ch[i] for ch in chunks])
                     for i in range(len(chunks[0])))

    def release(self):
        """Let go of this model's cache entries (a registry calls it when
        the version goes)."""
        with self._keys_lock:
            keys, self._keys = self._keys, set()
        for key in keys:
            aot.CACHE.release(key, self._owner)
