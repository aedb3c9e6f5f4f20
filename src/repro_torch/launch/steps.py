"""The LM's prefill and decode steps and the ViT's train step.

Counterparts of the ``prefill`` and ``decode`` closures of the reference's
``launch/steps.py:_lm_cell`` and the ``train_step`` of its ``_vis_cell``,
without mesh or sharding (one card).  The functions run eagerly;
:class:`LMGraphs` runs the prefill and the decode step as CUDA graphs on
the card, the counterpart of the reference's jit-compiled closures.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core.distill import ce_loss
from repro_torch.graphs import Graph, new_pool, pool_bytes
from repro_torch.models.transformer import (LMConfig, check_decodable,
                                            lm_apply, make_decode_caches)
from repro_torch.models.vit import ViTConfig, vit_apply
from repro_torch.optim.api import clip_by_global_norm, pop_grads


def make_vit_train_step(cfg: ViTConfig, update_fn: Callable) -> Callable:
    """The reference's ``vis_train`` step for the ViTs: cross entropy of
    the full net on the labels, the gradient clipped to global norm 1.0,
    one optimizer update.

    ``step(params, opt, batch, step) -> (params, opt, {"loss", "gnorm"})``
    with the parameters (leaves that require grad) and the optimizer state
    updated in place and the metrics as device scalars."""
    def step(params, opt, batch, step):
        pop_grads(params)
        logits, _ = vit_apply(params, batch["images"], cfg)
        loss = ce_loss(logits, batch["labels"])
        loss.backward()
        grads, gn = clip_by_global_norm(pop_grads(params), 1.0)
        params, opt = update_fn(params, grads, opt, step)
        return params, opt, {"loss": loss.detach(), "gnorm": gn}
    return step


def lm_prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig, *,
               E=None, max_len: Optional[int] = None,
               caches: Optional[dict] = None):
    """tokens (B, S) -> last-position logits (B, V), as the reference's
    prefill returns them.  With ``max_len``, also returns decode caches of
    ``max_len`` slots holding this prefill's k and v (filled to S), ready
    for :func:`lm_decode`: (logits, caches); with ``caches`` (from
    :func:`make_decode_caches`) it writes into those in place instead,
    their ``len`` set to S on the device (no host sync: a graph of it
    refills the same caches).  Like decode, that raises at a sliced depth
    or head count (fault F4)."""
    want = max_len is not None or caches is not None
    if want:
        check_decodable(cfg, E)
    logits, _, kv = lm_apply(params, tokens, cfg, E=E, return_kv=want)
    # a copy, not a view: a view would keep the (B, S, V) logits alive
    last = logits[:, -1, :].clone()
    if not want:
        return last
    B, S = tokens.shape
    if caches is None:
        caches = make_decode_caches(cfg, B, max_len, dtype=cfg.cdtype(),
                                    device=tokens.device)
    for name, layers in kv.items():
        for c, new in zip(caches[name], layers):
            c["k"][:, :S] = new["k"]
            c["v"][:, :S] = new["v"]
            c["len"].fill_(S)
            c["fill"] = S
    return last, caches


def lm_decode(params: dict, caches: dict, tokens: torch.Tensor,
              cfg: LMConfig, *, E=None):
    """One decode step: tokens (B, 1) against ``caches`` (updated in place)
    -> (logits (B, V), caches).  Raises NotImplementedError at a sliced
    depth or head count, where the reference's decode fails (fault F4)."""
    logits, _, caches = lm_apply(params, tokens, cfg, E=E, caches=caches)
    return logits[:, -1, :], caches


class LMGraphs:
    """The LM's prefill and decode step as CUDA graphs on the card.

    One prefill graph per (operating point, whether it writes the caches)
    over a static (B, S) prompt, and one decode-step graph per decodable
    point over a static (B, 1) token input, all over one set of static
    decode caches of ``max_len`` slots.  A prefill graph writes its k and
    v into the caches and sets their device ``len`` to S; a decode graph
    writes this step's k and v at ``len`` and advances ``len`` in place,
    so one graph serves every step, as the reference's decode executable
    does with its traced ``len``.  The host mirror ``fill`` of each cache
    is advanced here per replay, and a step that would overflow the
    caches raises before the replay.  The graphs share one memory pool
    and replay on the caller's stream.  Capture happens at first use (or
    :meth:`capture`); its eager warm-up and the capture leave the caches'
    ``len`` and ``fill`` as they were.
    """

    def __init__(self, params: dict, cfg: LMConfig, batch: int,
                 prefill_len: int, max_len: int, device: torch.device):
        self.params, self.cfg = params, cfg
        self.pool = new_pool()
        self.stream = torch.cuda.Stream(device)
        self.caches = make_decode_caches(cfg, batch, max_len,
                                         dtype=cfg.cdtype(), device=device)
        self.prompt = torch.zeros((batch, prefill_len), dtype=torch.long,
                                  device=device)
        self.step_in = torch.zeros((batch, 1), dtype=torch.long,
                                   device=device)
        self._graphs: Dict[tuple, Graph] = {}

    def _layers(self):
        for stack in self.caches.values():
            yield from stack

    @staticmethod
    def _point(E) -> tuple:
        return tuple(sorted((E or {}).items()))

    def _graph(self, key: tuple, fn: Callable, inputs) -> Graph:
        g = self._graphs.get(key)
        if g is None:
            saved = [(c, c["fill"], c["len"].clone()) for c in self._layers()]
            # capture from the state after a prefill: a decode step's
            # warm-up must find room in the caches
            S = self.prompt.shape[1]
            for c in self._layers():
                c["fill"] = S
                c["len"].fill_(S)
            try:
                g = Graph(fn, inputs, pool=self.pool, stream=self.stream)
            finally:
                for c, fill, n in saved:
                    c["fill"] = fill
                    c["len"].copy_(n)
            self._graphs[key] = g
        return g

    def _prefill_graph(self, E, caches: bool) -> Graph:
        def fn(tokens):
            with torch.inference_mode():
                if caches:
                    return lm_prefill(self.params, tokens, self.cfg, E=E,
                                      caches=self.caches)[0]
                return lm_prefill(self.params, tokens, self.cfg, E=E)
        return self._graph(("prefill", self._point(E), caches), fn,
                           [self.prompt])

    def _decode_graph(self, E) -> Graph:
        def fn(tokens):
            with torch.inference_mode():
                return lm_decode(self.params, self.caches, tokens, self.cfg,
                                 E=E)[0]
        return self._graph(("decode", self._point(E)), fn, [self.step_in])

    def capture(self, E=None, *, decodable: bool = True) -> None:
        """Capture the prefill graph at ``E`` (writing the caches when
        ``decodable``) and, when decodable, the decode-step graph."""
        self._prefill_graph(E, decodable)
        if decodable:
            self._decode_graph(E)

    def prefill(self, tokens: torch.Tensor, E=None, *,
                decodable: bool = True) -> torch.Tensor:
        """Replay the prefill of ``tokens`` (B, S): last-position logits
        (B, V), and when ``decodable`` the static caches filled to S."""
        out = self._prefill_graph(E, decodable).run(tokens)
        if decodable:
            for c in self._layers():
                c["fill"] = tokens.shape[1]
        return out

    def decode(self, tokens: torch.Tensor, E=None) -> torch.Tensor:
        """Replay one decode step of ``tokens`` (B, 1) against the static
        caches: logits (B, V).  Raises before the replay when a cache is
        full."""
        g = self._decode_graph(E)
        for c in self._layers():
            if c["fill"] + 1 > c["k"].shape[1]:
                raise ValueError(f"kv cache {tuple(c['k'].shape)} at len "
                                 f"{c['fill']} cannot take another step")
        out = g.run(tokens)
        for c in self._layers():
            c["fill"] += 1
        return out

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def pool_bytes(self) -> Optional[int]:
        """Device memory held by the graphs' pool."""
        return pool_bytes(self.pool)
