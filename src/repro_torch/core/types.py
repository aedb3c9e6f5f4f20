"""Core types for dynamic (elastic) networks.

The paper's algorithm knob is a *sub-network* of a trained supernet,
selected at runtime by the resource manager.  A sub-network is described by
a :class:`SubnetSpec` — a frozen, hashable dataclass so that it can key the
serving engine's per-subnet executable cache (sliced mode).

``ElasticSpace`` describes the *discrete* options the supernet was trained
for (the paper trains a small set of Pareto-optimal sub-networks).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple, Union

import numpy as np

# An "active dim" is either:
#   None          -> full dimension (not elastic here)
#   int           -> STATIC active size: params are sliced before the call
#   torch.Tensor  -> DYNAMIC active size (a device scalar): channels are masked
Active = Union[None, int, "torch.Tensor"]  # noqa: F821


def is_static(a: Active) -> bool:
    """True for None and Python/numpy ints; a torch tensor is dynamic."""
    return a is None or isinstance(a, (int, np.integer))


@dataclasses.dataclass(frozen=True)
class SubnetSpec:
    """A single sub-network of the supernet.  Hashable; keys compile caches.

    Multipliers apply to the *full* config dimension; ``spec_to_static``
    rounds them to active sizes.
    """

    width_mult: float = 1.0        # residual stream / conv channels
    ffn_mult: float = 1.0          # FFN hidden (or per-expert hidden)
    heads_mult: float = 1.0        # attention query heads
    depth_mult: float = 1.0        # fraction of layers (layer scaling)
    num_experts: Optional[int] = None   # MoE: active experts
    top_k: Optional[int] = None         # MoE: active top-k
    kernel_size: Optional[int] = None   # conv: elastic kernel (center crop)
    resolution: Optional[int] = None    # input resolution knob
    steps: Optional[int] = None         # diffusion sampler steps

    def name(self) -> str:
        parts = [
            f"w{self.width_mult:g}",
            f"f{self.ffn_mult:g}",
            f"h{self.heads_mult:g}",
            f"d{self.depth_mult:g}",
        ]
        if self.num_experts is not None:
            parts.append(f"e{self.num_experts}")
        if self.top_k is not None:
            parts.append(f"k{self.top_k}")
        if self.kernel_size is not None:
            parts.append(f"ks{self.kernel_size}")
        if self.resolution is not None:
            parts.append(f"r{self.resolution}")
        if self.steps is not None:
            parts.append(f"s{self.steps}")
        return "-".join(parts)


FULL = SubnetSpec()


@dataclasses.dataclass(frozen=True)
class ElasticSpace:
    """The discrete sub-network design space the supernet supports."""

    width_mults: Tuple[float, ...] = (1.0,)
    ffn_mults: Tuple[float, ...] = (1.0,)
    heads_mults: Tuple[float, ...] = (1.0,)
    depth_mults: Tuple[float, ...] = (1.0,)
    expert_counts: Tuple[int, ...] = ()
    top_ks: Tuple[int, ...] = ()
    kernel_sizes: Tuple[int, ...] = ()
    round_to: int = 1                  # the reference's field; unused here

    def min_spec(self) -> SubnetSpec:
        return SubnetSpec(
            width_mult=min(self.width_mults),
            ffn_mult=min(self.ffn_mults),
            heads_mult=min(self.heads_mults),
            depth_mult=min(self.depth_mults),
            num_experts=min(self.expert_counts) if self.expert_counts else None,
            top_k=min(self.top_ks) if self.top_ks else None,
            kernel_size=min(self.kernel_sizes) if self.kernel_sizes else None,
        )

    def max_spec(self) -> SubnetSpec:
        return FULL

    def enumerate(self, limit: Optional[int] = None) -> Tuple[SubnetSpec, ...]:
        """Cartesian enumeration of the space (optionally capped)."""
        experts: Sequence = self.expert_counts or (None,)
        topks: Sequence = self.top_ks or (None,)
        kss: Sequence = self.kernel_sizes or (None,)
        out = []
        for w, f, h, d, e, k, ks in itertools.product(
            self.width_mults, self.ffn_mults, self.heads_mults,
            self.depth_mults, experts, topks, kss,
        ):
            out.append(SubnetSpec(w, f, h, d, e, k, ks))
            if limit is not None and len(out) >= limit:
                break
        return tuple(out)
