"""Continuous batching for decode serving, as ``repro/serve/batcher.py``.

Requests arrive online (like the paper's jobs); the batcher keeps a
fixed-width decode batch full by swapping finished rows for queued
requests at step granularity.  A request's prompt is teacher-forced one
token a step through the decode path, so a released row's cache slots
are overwritten by the next request's prompt.

Row isolation: attention and MLA caches are masked by each row's own
length (``models/model.py::decode_step`` with a (B,) ``cache_len``), so
stale entries beyond a row's cursor are invisible and rows can be reused
without clearing.  SSM and hybrid rows would also need their recurrent
state zeroed on admit; the reference's docstring names a reset hook for
that, but the reference has none, and neither has this module.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from .. import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (P,) integer tokens
    max_new: int
    arrived_step: int = 0
    # filled by the batcher
    output: Optional[List[int]] = None
    started_step: int = -1
    finished_step: int = -1


@dataclasses.dataclass
class _Row:
    req: Optional[Request] = None
    pos: int = 0                   # next cache position for this row
    prompt_left: int = 0


class ContinuousBatcher:
    """Drives a decode step with per-row request management.

    ``decode_fn(tokens (B, 1), cache, cache_len (B,)) -> (logits, cache)``,
    both tensors int64 on ``device`` (None: the card): each row is at its
    own position, its token written at its own offset.  Rows without a
    request decode a pad token, and their outputs are ignored.
    """

    def __init__(self, batch: int, max_len: int, decode_fn: Callable,
                 eos_id: int = -1,
                 device: Optional[Union[str, torch.device]] = None):
        self.batch = batch
        self.max_len = max_len
        self.decode_fn = decode_fn
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self.rows = [_Row() for _ in range(batch)]
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self.step_no = 0

    def submit(self, req: Request) -> None:
        req.arrived_step = self.step_no
        self.queue.append(req)

    def _admit(self) -> None:
        for row in self.rows:
            if row.req is None and self.queue:
                req = self.queue.pop(0)
                req.output = []
                req.started_step = self.step_no
                row.req = req
                row.pos = 0
                row.prompt_left = len(req.prompt)

    @property
    def active(self) -> int:
        return sum(r.req is not None for r in self.rows)

    def step(self, cache, pad_token: int = 0):
        """One global decode step; returns (cache, finished this step)."""
        self._admit()
        toks = np.full((self.batch, 1), pad_token, np.int64)
        for i, row in enumerate(self.rows):
            if row.req is None:
                continue
            if row.prompt_left > 0:     # teacher-forced prompt
                toks[i, 0] = row.req.prompt[len(row.req.prompt) -
                                            row.prompt_left]
            elif row.req.output:
                toks[i, 0] = row.req.output[-1]
            else:
                toks[i, 0] = row.req.prompt[-1]
        positions = np.array([r.pos for r in self.rows], np.int64)
        logits, cache = self.decode_fn(
            torch.from_numpy(toks).to(self.device), cache,
            torch.from_numpy(positions).to(self.device))
        # the argmax over the full padded row, read back once
        nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
        finished = []
        for i, row in enumerate(self.rows):
            if row.req is None:
                continue
            row.pos += 1
            if row.prompt_left > 1:
                row.prompt_left -= 1
                continue
            if row.prompt_left == 1:
                row.prompt_left = 0     # prompt consumed; first output next
            row.req.output.append(int(nxt[i]))
            done = (len(row.req.output) >= row.req.max_new
                    or int(nxt[i]) == self.eos_id
                    or row.pos >= self.max_len - 1)
            if done:
                row.req.finished_step = self.step_no
                finished.append(row.req)
                self.done.append(row.req)
                row.req = None
        self.step_no += 1
        return cache, finished

    def run(self, cache, max_steps: int = 10000):
        while (self.queue or self.active) and self.step_no < max_steps:
            cache, _ = self.step(cache)
        return cache
