"""Mixture of experts with expert parallelism (counterpart of
``incubator_mxnet_tpu/parallel/moe.py``).

Top-k gating with the GShard recipe: per-expert capacity
``C = ceil(k*T/E * capacity_factor)``, position in expert by a cumulative
sum (all first choices before any second), tokens over capacity dropped,
and a dispatch/combine einsum; ``capacity_factor=None`` is the dense,
capacity-free dispatch (every token reaches its top-k experts). The
auxiliary loss is Switch's load-balancing loss plus ``z_loss_coef`` times
ST-MoE's router z-loss.

``w1`` (E, D, H) and ``w2`` (E, H, D) carry ``P(ep, None, None)``. Under a
mesh with an ``ep`` axis of more than one position (``current_mesh()``)
the routing is computed once, then each position computes its experts'
share of the output from its slice of ``w1``, ``w2`` and of the combine
weights (``shard_map``), and the shares are summed (``psum`` in fp32).
"""
from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from ..gluon.block import HybridBlock
from ..gluon.parameter import Parameter
from .compat import psum, shard_map
from .mesh import P, current_mesh

__all__ = ["MoELayer", "load_balancing_loss", "router_z_loss"]


def load_balancing_loss(gates, top_idx, num_experts):
    """Switch-Transformer aux loss ``E * sum_e f_e * p_e``: ``f_e`` the
    fraction of tokens whose first choice is e, ``p_e`` the mean gate."""
    p = gates.mean(dim=0)
    f = F.one_hot(top_idx[:, 0].long(), num_experts).to(gates.dtype) \
        .mean(dim=0)
    return num_experts * (f * p).sum()


def router_z_loss(logits):
    """ST-MoE router z-loss: ``mean(logsumexp(logits)^2)``."""
    return torch.logsumexp(logits, dim=-1).square().mean()


def _experts_dense(tokens, combine, w1, w2, act):
    """Capacity-free experts: every token through every (local) expert,
    weighted by ``combine`` (T, E)."""
    h = act(torch.einsum("td,edh->eth", tokens, w1))
    y = torch.einsum("eth,ehd->etd", h, w2)
    return torch.einsum("etd,te->td", y, combine)


def _experts_capacity(tokens, combine, w1, w2, act):
    """Capacity experts: ``combine`` (T, E, C) holds each kept token's gate
    weight at its slot; dispatch is where it is positive."""
    dispatch = (combine > 0.0).to(tokens.dtype)
    expert_in = torch.einsum("tec,td->ecd", dispatch, tokens)
    h = act(torch.einsum("ecd,edh->ech", expert_in, w1))
    y = torch.einsum("ech,ehd->ecd", h, w2)
    return torch.einsum("tec,ecd->td", combine.to(y.dtype), y)


def _capacity_combine(top_vals, top_idx, num_experts, capacity):
    """(T, E, C) combine weights of the GShard dispatch: position in expert
    by the cumulative sum over (k, token) order; over capacity dropped."""
    T, k = top_idx.shape
    oh = F.one_hot(top_idx.long(), num_experts).float()          # (T,k,E)
    flat = oh.transpose(0, 1).reshape(k * T, num_experts)
    pos = torch.cumsum(flat, dim=0) - flat
    pos = (pos * flat).sum(-1).reshape(k, T).transpose(0, 1).long()
    keep = pos < capacity
    gate_w = torch.where(keep, top_vals, torch.zeros_like(top_vals))
    pos_oh = F.one_hot(pos.clamp_max(capacity), capacity + 1)[..., :capacity] \
        .float()                                                  # (T,k,C)
    return torch.einsum("tk,tke,tkc->tec", gate_w.float(), oh, pos_oh)


class MoELayer(HybridBlock):
    """Top-k gated MoE FFN: ``y = sum_k g_k * FFN_{e_k}(x)``. ``forward``
    returns the output; ``forward_with_aux`` also the auxiliary loss."""

    def __init__(self, num_experts, hidden_size, ffn_hidden, top_k=2,
                 ep_axis="ep", activation="relu", capacity_factor=None,
                 z_loss_coef=1e-3, **kwargs):
        super().__init__(**kwargs)
        if capacity_factor is None and num_experts >= 8:
            warnings.warn(
                "MoELayer(num_experts=%d, capacity_factor=None): the dense "
                "capacity-free dispatch is O(T*E) compute and defeats "
                "expert parallelism at scale — pass capacity_factor "
                "(GShard default 1.25) for real workloads" % num_experts,
                stacklevel=2)
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.z_loss_coef = z_loss_coef
        self._act = activation
        self._ep_axis = ep_axis
        self.gate_weight = Parameter("gate_weight",
                                     shape=(num_experts, hidden_size),
                                     init="xavier")
        self.w1 = Parameter("w1", shape=(num_experts, hidden_size,
                                         ffn_hidden), init="xavier")
        self.w2 = Parameter("w2", shape=(num_experts, ffn_hidden,
                                         hidden_size), init="xavier")
        self.w1.sharding = P(ep_axis, None, None)
        self.w2.sharding = P(ep_axis, None, None)

    def _activation(self, x):
        if self._act == "relu":
            return F.relu(x)
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default

    def _fn(self, x, compute_aux):
        from ..ndarray import NDArray
        wrap = isinstance(x, NDArray)
        xd = x._data if wrap else x
        gw = self.gate_weight._tensor()
        w1, w2 = self.w1._tensor(), self.w2._tensor()
        top_k, num_experts = self.top_k, self.num_experts
        shape = xd.shape
        tokens = xd.reshape(-1, shape[-1])
        logits = tokens @ gw.t()
        gates = torch.softmax(logits, dim=-1)
        top_vals, top_idx = torch.topk(gates, top_k, dim=-1)
        top_vals = top_vals / top_vals.sum(-1, keepdim=True)
        if self.capacity_factor is None:
            oh = F.one_hot(top_idx, num_experts).to(gates.dtype)
            combine = torch.einsum("tk,tke->te", top_vals, oh)
            experts, espec = _experts_dense, P(None, self._ep_axis)
        else:
            T = tokens.shape[0]
            capacity = max(1, int(-(-top_k * T * self.capacity_factor
                                    // num_experts)))
            combine = _capacity_combine(top_vals, top_idx, num_experts,
                                        capacity)
            experts, espec = _experts_capacity, P(None, self._ep_axis, None)
        mesh = current_mesh()
        if mesh is not None and mesh.shape.get(self._ep_axis, 1) > 1:
            axis = self._ep_axis

            def share(t, c, a, b):
                return psum(experts(t, c, a, b, self._activation).float(),
                            axis)
            out = shard_map(share, mesh,
                            in_specs=(P(), espec, P(axis), P(axis)),
                            out_specs=P(), axes=(axis,))(
                tokens, combine, w1, w2).to(tokens.dtype)
        else:
            out = experts(tokens, combine, w1, w2, self._activation)
        out = out.reshape(shape)
        if wrap:
            out = NDArray(out)
        if not compute_aux:
            return out
        aux = load_balancing_loss(gates, top_idx, num_experts) \
            + self.z_loss_coef * router_z_loss(logits)
        return out, (NDArray(aux) if wrap else aux)

    def forward(self, x):
        """x: (..., D) → (..., D)."""
        return self._fn(x, compute_aux=False)

    def forward_with_aux(self, x):
        """(y, aux): aux = Switch load-balancing loss + z_loss_coef *
        ST-MoE router z-loss (add it to the task loss)."""
        return self._fn(x, compute_aux=True)
