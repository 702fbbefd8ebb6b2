"""Serving: prefill + single-token decode steps and a batched engine.

The counterpart of ``repro.serve.serve_step``, with the same left-padding,
the same shared position counter and the same greedy choice, so that both
packages give the same tokens for the same weights and requests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.cache import init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Transformer, decode_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(model, cache, token (B,), pos) -> (next_token (B,), cache,
    logits); greedy; the cache is written in place."""

    def step(model, cache, token, pos):
        logits, cache = decode_step(model, cfg, cache, token, pos)
        nxt = torch.argmax(logits, dim=-1)
        return nxt, cache, logits

    return step


def prefill(model: Transformer, cfg: ModelConfig, cache: dict,
            tokens: torch.Tensor):
    """Sequential prefill through the decode path (cache-filling), one
    position at a time, as the JAX package's ``prefill`` does.  Returns
    (cache, last logits)."""
    logits = None
    for i in range(tokens.shape[1]):
        logits, cache = decode_step(model, cfg, cache, tokens[:, i], i)
    return cache, logits


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: Optional[np.ndarray] = None


class ServingEngine:
    """Greedy batched serving loop over a fixed slot count.

    All slots share one position counter (left-padded prompts), as in the
    JAX package.  ``device`` defaults to the card and must be where the
    model's parameters lie.
    """

    def __init__(self, cfg: ModelConfig, model: Transformer, slots: int,
                 max_seq: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        param_dev = model.embed.device
        if param_dev.type != self.device.type or (
                self.device.index is not None
                and param_dev.index != self.device.index):
            raise ValueError(f"model lies on {param_dev}, engine device is "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.slots = slots
        self.max_seq = max_seq
        self.step = make_serve_step(cfg)

    def run(self, requests: List[Request]) -> List[Request]:
        cfg = self.cfg
        done: List[Request] = []
        for i in range(0, len(requests), self.slots):
            chunk = requests[i:i + self.slots]
            B = len(chunk)
            plen = max(len(r.prompt) for r in chunk)
            if plen + max(r.max_new for r in chunk) > self.max_seq:
                raise ValueError(f"prompt {plen} + new tokens exceed "
                                 f"max_seq={self.max_seq}")
            toks = np.zeros((B, plen), np.int64)
            for j, r in enumerate(chunk):
                toks[j, plen - len(r.prompt):] = r.prompt
            toks_d = torch.from_numpy(toks).to(self.device)
            cache = init_cache(cfg, B, self.max_seq, self.device)
            cache, _ = prefill(self.model, cfg, cache, toks_d)
            tok = toks_d[:, -1]
            outs = []
            max_new = max(r.max_new for r in chunk)
            for t in range(max_new):
                tok, cache, _ = self.step(self.model, cache, tok, plen + t)
                outs.append(tok)
            outs = torch.stack(outs, 1).cpu().numpy()
            for j, r in enumerate(chunk):
                r.out = outs[j, :r.max_new]
                done.append(r)
        return done
