"""AdamW with multi-precision state and decoupled weight decay.

The port's copy of ``repro.optim.adamw``, over the port's parameter tree
(nested dicts and lists of tensors, :mod:`repro_torch.tree`).
As the reference: ``init(params) -> state``, ``update(grads, state,
params, lr) -> (updates, state)``, ``apply_updates(params, updates)``;
``update`` writes the new moments into ``state``'s tensors (donated, as
the reference's jitted step donates its state), so the moments are never
held twice.  Moments are stored in ``state_dtype``, the arithmetic is
float32, and the updates are cast to each parameter's dtype; there are no
float32 master weights (the reference keeps none).

**Weight decay follows the reference's decisions.**  The reference
decays a leaf when ``ndim >= 2`` on its own tree, where each pattern
position's parameters are stacked on a leading layer dim (``blocks``),
so every per-layer vector (norm scales, biases, ``A_log``, RG-LRU's
``lam``) is 2-D there and decayed; only top-level vectors
(``final_norm``) and the unstacked ``remainder`` layers' vectors are not.
The port keeps one dict per layer, so :func:`reference_decay_mask` counts
one more dim for a leaf of a layer the reference stacks (the layers
before the remainder, by ``transformer.pattern_of``; every layer of an
``encdec`` tree's ``enc_blocks`` and ``dec_blocks``), and ``AdamW``
takes it from the config of the model whose tree it updates.  The decay
of these vectors is a property of the reference (ROADMAP.md queue 3),
kept here.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig
from ..models.transformer import pattern_of
from ..tree import tree_leaves, tree_leaves_with_path, tree_map

__all__ = ["AdamWState", "AdamW", "reference_decay_mask"]

DecayMask = Callable[[Tuple, torch.Tensor], bool]


class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32, on the CPU
    mu: Any               # tree like params (state_dtype)
    nu: Any               # tree like params (state_dtype)


def reference_decay_mask(cfg: ModelConfig) -> DecayMask:
    """``fn(path, leaf) -> bool``: the reference's ``ndim >= 2`` on its
    stacked layout, for the port's tree of ``cfg``'s model."""
    if cfg.family == "encdec":
        def stacked(path):
            return path[0] in ("enc_blocks", "dec_blocks")
    else:
        pat, repeats, _ = pattern_of(cfg)
        n_stacked = repeats * len(pat)

        def stacked(path):
            return path[0] == "layers" and path[1] < n_stacked
    return lambda path, leaf: leaf.dim() + int(stacked(path)) >= 2


class AdamW:
    def __init__(
        self,
        b1: float = 0.9,
        b2: float = 0.95,
        eps: float = 1e-8,
        weight_decay: float = 0.1,
        *,
        cfg: ModelConfig,                          # the model whose tree this updates
        state_dtype: torch.dtype = torch.float32,  # bf16 moments halve optimizer memory
    ) -> None:
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.decay_mask = reference_decay_mask(cfg)
        self.state_dtype = state_dtype

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.state_dtype, device=p.device)

        return AdamWState(step=torch.zeros((), dtype=torch.int32), mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def abstract_state(self, abstract_params) -> AdamWState:
        """``init``'s state over a tree of ``meta`` tensors, as ``meta`` tensors."""
        def meta(p):
            return torch.empty(p.shape, dtype=self.state_dtype, device="meta")

        return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                          mu=tree_map(meta, abstract_params), nu=tree_map(meta, abstract_params))

    @staticmethod
    def state_specs(param_specs) -> AdamWState:
        """The state's logical axes: the moments mirror the parameters'."""
        return AdamWState(step=(), mu=param_specs, nu=param_specs)

    def decays(self, params) -> dict:
        """{path: whether the leaf at path is decayed}."""
        return {path: bool(self.decay_mask(path, p))
                for path, p in tree_leaves_with_path(params)}

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr) -> Tuple[Any, AdamWState]:
        """(updates, the new state, whose moments are ``state``'s tensors
        updated in place: the old state is gone)."""
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        f32 = torch.float32
        c1 = 1.0 - torch.tensor(b1, dtype=f32) ** step.to(f32)
        c2 = 1.0 - torch.tensor(b2, dtype=f32) ** step.to(f32)
        decays = self.decays(params)

        def upd(path, g, m, v, p):
            gf = g.to(f32)
            mf = b1 * m.to(f32) + (1 - b1) * gf
            vf = b2 * v.to(f32) + (1 - b2) * gf * gf
            mhat = mf / c1
            vhat = vf / c2
            u = mhat / (torch.sqrt(vhat) + self.eps)
            if self.wd and decays[path]:
                u = u + self.wd * p.to(f32)
            return (-lr * u).to(p.dtype), m.copy_(mf), v.copy_(vf)

        outs = [upd(path, g, m, v, p) for (path, g), m, v, p in zip(
            tree_leaves_with_path(grads), tree_leaves(state.mu), tree_leaves(state.nu),
            tree_leaves(params))]

        def rebuild(i):
            it = iter([o[i] for o in outs])
            return tree_map(lambda _: next(it), grads)

        updates, mu, nu = rebuild(0), rebuild(1), rebuild(2)
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    @staticmethod
    @torch.no_grad()
    def apply_updates(params, updates):
        return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
