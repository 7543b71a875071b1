"""Model factory: one API over every architecture of the repo.

The port's copy of ``repro.models.model_factory``: ``init``, ``forward``,
``logits``, the training loss ``loss_fn``, and for serving
``init_caches``, ``prefill``, ``prefill_from`` and ``decode_step``.  The
serving methods run under ``torch.no_grad()``; ``loss_fn`` runs its
forward with grad enabled, checkpointing the reference's units under
``cfg.parallel.remat``, and its gradients are autograd's
(``launch/steps.py``).

The ``encdec`` family (whisper) takes ``frames=`` (B, S_enc, d) and the
``vlm`` family ``image_embeds=`` (B, n_img, d), the reference's batch keys,
at ``forward``, ``prefill`` and ``prefill_from``; at decode their cross
caches stand in for both, as in the reference.  One deliberate difference
(ROADMAP.md queue 3): a ``vlm`` forward other than decode without
``image_embeds`` raises, where the reference attends the text to itself
in the cross layers and, at prefill, writes the text's keys into the
cross caches.

On a mesh the train step hands ``forward`` and ``loss_fn`` a
``TensorParallel`` (``tp``) and this rank's blocks of the parameters:
the blocks run their tensor-parallel forms, and the loss's head is
column-parallel over this rank's block of the vocabulary (``lm_head``'s
columns, or the tied table's rows) with a vocab-parallel cross-entropy:
the row max and the sum of exponentials are reduced over ``model``, and
the label's logit comes from the rank whose block holds it.  The serving
methods take ``tp`` too (``launch/steps.py``'s prefill and decode
steps): their caches are this rank's (``init_caches(..., tp=tp)``), a
forward whose length the model size does not divide runs without
sequence parallelism, and the logits leave as this rank's block of the
vocabulary, the reference's ``("act_batch", "act_vocab")`` layout;
:func:`greedy_tokens` takes the argmax over the model group.

The dry-run's half of the reference's ``Model`` is here as well:
``abstract_caches`` / ``cache_specs`` (one cache per layer, each leaf
with the reference's logical axes), ``input_specs`` (``meta`` tensors)
and ``model_flops``.

``Model(cfg, device=...)`` builds its tensors on ``device`` ("cuda"
unless the caller asks for the CPU).  ``plain=True`` runs prefill through
the kernels' plain PyTorch versions on any device; it exists for
comparisons and is never the default.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from .. import tracing
from ..configs.base import InputShape, ModelConfig
from ..parallel.collectives import gather_seq, reduce_from
from ..parallel.tensor_parallel import TensorParallel
from . import encdec, transformer
from .layers import DTYPES, AbstractBuilder, ParamBuilder, SpecBuilder, cross_entropy_loss

__all__ = ["Model", "make_model", "splice_slot", "greedy_tokens", "MOE_AUX_COEF", "MOE_Z_COEF"]

MOE_AUX_COEF = 0.01
MOE_Z_COEF = 1e-3


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: Union[str, torch.device] = "cuda"
    plain: bool = False

    def __post_init__(self):
        if self.cfg.family != "encdec":
            transformer.pattern_of(self.cfg)  # raises for an unknown family

    # -- parameters ---------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters with the reference's init scales, drawn from a
        ``torch.Generator`` seeded with ``seed`` on the model's device."""
        return self._build(ParamBuilder(seed, DTYPES[self.cfg.param_dtype], self.device))

    def abstract_params(self) -> Dict[str, Any]:
        """``init()``'s tree with each parameter as a ``meta`` tensor (its
        shape and dtype; nothing allocated)."""
        return self._build(AbstractBuilder(DTYPES[self.cfg.param_dtype]))

    def param_specs(self) -> Dict[str, Any]:
        """``init()``'s tree with each parameter's logical axes (a tuple of
        names or ``None``, one per dim) in its place."""
        return self._build(SpecBuilder())

    def _build(self, builder):
        if self.cfg.family == "encdec":
            return encdec.build_encdec_params(builder, self.cfg)
        return transformer.build_decoder_params(builder, self.cfg)

    # -- forward ------------------------------------------------------------
    def forward(self, params, tokens: torch.Tensor, *, mode: str = "train",
                positions: Optional[torch.Tensor] = None, caches=None,
                aux: Optional[Dict[str, torch.Tensor]] = None,
                frames: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None,
                tp: Optional[TensorParallel] = None):
        """Returns (hidden (B, S, d), caches); ``aux``, when given, receives
        the MoE aux values (``transformer.AUX_KEYS``).  ``frames``
        (``encdec``) and ``image_embeds`` (``vlm``) are the second input
        outside decode.  ``tp``: this rank's part on a mesh; a serving
        forward of a length the model size does not divide runs without
        sequence parallelism."""
        cfg = self.cfg
        if cfg.family in ("encdec", "vlm") and mode == "decode":
            # the cross caches hold the source: a one-row stand-in marks cross
            source = torch.zeros((tokens.shape[0], 1, cfg.d_model), dtype=DTYPES[cfg.dtype],
                                 device=tokens.device)
            frames = image_embeds = source
        if tp is not None and mode != "train":
            tp = tp.at_length(tokens.shape[1])
        if cfg.family == "encdec":
            if frames is None:
                raise ValueError("the encdec family needs frames= (B, S_enc, d_model)")
            enc_out = frames
            if mode != "decode":
                enc_tp = tp if tp is None or mode == "train" else tp.at_length(frames.shape[1])
                enc_out = encdec.encoder_forward(params, frames, cfg, plain=self.plain,
                                                 remat=transformer.remat_enabled(cfg, mode),
                                                 tp=enc_tp)
                if tp is not None and tp.size > 1:  # whole and replicated, for every layer
                    enc_out = enc_tp.enter(enc_out)
            hidden, caches = encdec.decoder_forward_encdec(
                params, tokens, enc_out, cfg, mode=mode, positions=positions, caches=caches,
                plain=self.plain, tp=tp)
            if aux is not None:
                aux.update({key: torch.zeros((), dtype=torch.float32, device=hidden.device)
                            for key in transformer.AUX_KEYS})
            return hidden, caches
        if cfg.family == "vlm" and image_embeds is None:
            raise ValueError("the vlm family needs image_embeds= (B, n_img, d_model) outside "
                             "decode (ROADMAP.md queue 3: a deliberate difference from the "
                             "reference, which attends the text to itself there)")
        return transformer.decoder_forward(params, tokens, cfg, mode=mode,
                                           positions=positions, caches=caches,
                                           image_embeds=image_embeds, plain=self.plain, aux=aux,
                                           tp=tp)

    def logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        if self.cfg.family == "encdec":
            return hidden @ params["embed"].T
        return transformer.lm_logits(params, hidden, self.cfg)

    # -- training loss (chunked over the sequence: no full logits) ---------
    def loss_fn(self, params, batch: Dict[str, torch.Tensor], *, loss_chunk: int = 1024,
                tp: Optional[TensorParallel] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of one batch: ``tokens``, ``labels`` (B, S),
        optional ``mask`` (B, S) float, and ``frames`` (encdec) or
        ``image_embeds`` (vlm).  With ``loss_chunk`` dividing S (and below
        it) the logits are formed one chunk of positions at a time, as in
        the reference.  ``metrics`` holds ``ce_loss``, ``loss`` and the MoE
        aux values; a ``moe`` model's loss adds ``MOE_AUX_COEF`` ·
        ``moe_aux_loss`` and ``MOE_Z_COEF`` · ``moe_z_loss``.  With ``tp``
        (a mesh) the batch is this rank's rows and ``params`` its blocks."""
        cfg = self.cfg
        aux: Dict[str, torch.Tensor] = {}
        hidden, _ = self.forward(params, batch["tokens"], mode="train", aux=aux,
                                 frames=batch.get("frames"),
                                 image_embeds=batch.get("image_embeds"), tp=tp)
        labels = batch["labels"]
        mask = batch.get("mask")
        s = labels.shape[1]
        head = (params["embed"].T if cfg.tie_embeddings or cfg.family == "encdec"
                else params.get("lm_head"))
        with tracing.span("loss"):
            if tp is not None and tp.size > 1:
                chunk = loss_chunk if loss_chunk and s % loss_chunk == 0 else s
                loss = _vocab_parallel_loss(tp.enter(hidden), head, labels, mask, tp, chunk)
            elif loss_chunk and s > loss_chunk and s % loss_chunk == 0:
                tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
                denom = torch.zeros((), dtype=torch.float32, device=hidden.device)
                for c in range(s // loss_chunk):
                    cols = slice(c * loss_chunk, (c + 1) * loss_chunk)
                    lf = (hidden[:, cols] @ head).float()
                    lse = torch.logsumexp(lf, dim=-1)
                    picked = torch.gather(lf, -1, labels[:, cols].long()[..., None])[..., 0]
                    m = (mask[:, cols].float() if mask is not None
                         else torch.ones_like(lse))
                    tot = tot + torch.sum((lse - picked) * m)
                    denom = denom + torch.sum(m)
                loss = tot / torch.clamp(denom, min=1.0)
            else:
                loss, _ = cross_entropy_loss(self.logits(params, hidden), labels, mask)
        if tracing.enabled():
            chain = tracing.BackwardChain()
            chain.layer(0, "loss.backward", hidden)
            chain.end(loss)
        metrics = {"ce_loss": loss, **aux}
        if cfg.family == "moe":
            loss = loss + MOE_AUX_COEF * aux["moe_aux_loss"] + MOE_Z_COEF * aux["moe_z_loss"]
        metrics["loss"] = loss
        return loss, metrics

    # -- serving ------------------------------------------------------------
    def init_caches(self, batch: int, max_len: int, *,
                    tp: Optional[TensorParallel] = None) -> List[Any]:
        """Empty caches; with ``tp``, this model rank's (what it computes with)."""
        if self.cfg.family == "encdec":
            return encdec.init_encdec_caches(self.cfg, batch, max_len, self.cfg.encoder_seq,
                                             device=self.device, tp=tp)
        return transformer.init_caches(self.cfg, batch, max_len, device=self.device, tp=tp)

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, max_len: int, *,
                frames: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None,
                tp: Optional[TensorParallel] = None) -> Tuple[torch.Tensor, List[Any]]:
        """Full-sequence prefill → (last-position logits (B, V), filled caches)."""
        return self.prefill_from(params, tokens,
                                 self.init_caches(tokens.shape[0], max_len, tp=tp),
                                 frames=frames, image_embeds=image_embeds, tp=tp)

    @torch.no_grad()
    def prefill_from(self, params, tokens: torch.Tensor, caches, *,
                     frames: Optional[torch.Tensor] = None,
                     image_embeds: Optional[torch.Tensor] = None,
                     tp: Optional[TensorParallel] = None) -> Tuple[torch.Tensor, List[Any]]:
        """Prefill into caches that already exist → (last-position logits
        (B, V), caches filled in place), as the reference's ``prefill_from``:
        a KV cache is rewritten from position 0, an SSM or RG-LRU state is
        continued, a cross cache takes the new source's keys.  With ``tp``
        the logits are this rank's block of the vocabulary."""
        hidden, caches = self.forward(params, tokens, mode="prefill", caches=caches,
                                      frames=frames, image_embeds=image_embeds, tp=tp)
        last = hidden[:, -1:, :]
        if tp is not None and tp.at_length(tokens.shape[1]).sp:
            # the last position lies in the last model rank's block of the sequence
            last = gather_seq(last, tp.group)[:, -1:, :]
        return self.logits(params, last)[:, 0, :], caches

    @torch.no_grad()
    def decode_step(self, params, tokens: torch.Tensor, positions: torch.Tensor, caches, *,
                    tp: Optional[TensorParallel] = None) -> Tuple[torch.Tensor, List[Any]]:
        """tokens, positions: (B, 1) → (logits (B, V), caches updated in
        place); with ``tp`` the logits are this rank's block of the vocabulary."""
        hidden, caches = self.forward(params, tokens, mode="decode", positions=positions,
                                      caches=caches, tp=tp)
        return self.logits(params, hidden)[:, 0, :], caches

    # -- the dry-run's stand-ins (meta tensors, nothing allocated) ----------
    def abstract_caches(self, batch: int, max_len: int) -> List[Any]:
        """``init_caches``' list as ``meta`` tensors."""
        return Model(self.cfg, device="meta").init_caches(batch, max_len)

    def cache_specs(self, batch: int = 0, max_len: int = 0) -> List[Any]:
        """``init_caches``' list with each leaf's logical axes in its place."""
        if self.cfg.family == "encdec":
            return encdec.encdec_cache_specs(self.cfg)
        return transformer.cache_specs(self.cfg)

    def input_specs(self, shape: InputShape) -> Dict[str, Any]:
        """The step's inputs for ``shape`` as ``meta`` tensors, as the
        reference's: ``{"batch": {...}}`` for train and prefill, the
        decode step's ``tokens``, ``positions`` and ``caches`` (of
        ``shape.seq_len`` rows) for decode."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def meta(shape_, dtype):
            return torch.empty(shape_, dtype=dtype, device="meta")

        if shape.kind == "decode":
            return {"tokens": meta((b, 1), torch.int32), "positions": meta((b, 1), torch.int32),
                    "caches": self.abstract_caches(b, s)}
        batch = {"tokens": meta((b, s), torch.int32)}
        if shape.kind == "train":
            batch.update(labels=meta((b, s), torch.int32), mask=meta((b, s), torch.float32))
        act = DTYPES[cfg.dtype]
        if cfg.family == "encdec":
            batch["frames"] = meta((b, cfg.encoder_seq, cfg.d_model), act)
        if cfg.family == "vlm":
            batch["image_embeds"] = meta((b, cfg.num_image_tokens, cfg.d_model), act)
        return {"batch": batch}

    def model_flops(self, shape: InputShape) -> float:
        """6·N·tokens for a training step, 2·N·tokens for prefill and
        decode (one token a row), N the active parameters."""
        n = self.cfg.active_param_count()
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        return (6.0 if shape.kind == "train" else 2.0) * n * tokens


def _vocab_parallel_loss(hidden: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor], tp: TensorParallel,
                         chunk: int) -> torch.Tensor:
    """The masked mean token NLL of ``hidden`` (whole and replicated over
    the model group) against ``head`` (d, this rank's block of the
    vocabulary), ``chunk`` positions at a time."""
    rows = head.shape[1]
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    denom = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(hidden.shape[1] // chunk):
        cols = slice(c * chunk, (c + 1) * chunk)
        lf = (hidden[:, cols] @ head).float()                         # (B, c, V / model)
        top = tp.group.all_reduce(lf.detach().amax(dim=-1), "max")
        lse = torch.log(reduce_from(torch.exp(lf - top[..., None]).sum(dim=-1), tp.group)) + top
        local = labels[:, cols].long() - tp.rank * rows
        inside = (local >= 0) & (local < rows)
        picked = torch.gather(lf, -1, local.clamp(0, rows - 1)[..., None])[..., 0]
        picked = reduce_from(torch.where(inside, picked, torch.zeros_like(picked)), tp.group)
        m = mask[:, cols].float() if mask is not None else torch.ones_like(lse)
        tot = tot + torch.sum((lse - picked) * m)
        denom = denom + torch.sum(m)
    return tot / torch.clamp(denom, min=1.0)


def greedy_tokens(logits: torch.Tensor, tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """(B,) int64: the argmax of each row of ``logits`` (B, V), or with
    ``tp`` of this rank's block (B, V / size) of them over the model
    group: the row maximum, then the lowest index that reaches it
    (``argmax``'s rule)."""
    if tp is None or tp.size == 1:
        return logits.argmax(dim=-1)
    cols = logits.shape[-1]
    lf = logits.float()
    top = tp.group.all_reduce(lf.amax(dim=-1), "max")
    hit = lf == top[:, None]
    first = hit.int().argmax(dim=-1) + tp.rank * cols
    # the lowest index over the group, as the max of the negated ones
    none = torch.full_like(first, tp.size * cols)
    return -tp.group.all_reduce(-torch.where(hit.any(dim=-1), first, none), "max")


def make_model(cfg: ModelConfig, *, device: Union[str, torch.device] = "cuda",
               plain: bool = False) -> Model:
    """The model of ``cfg``, of any family of the repo."""
    return Model(cfg, device=device, plain=plain)


def splice_slot(batched: List[Any], single: List[Any], slot: int) -> None:
    """Copy a batch-1 cache list into slot ``slot`` of a batched one, in place."""
    for big, one in zip(batched, single):
        for field in dataclasses.fields(big):
            getattr(big, field.name)[slot].copy_(getattr(one, field.name)[0])
