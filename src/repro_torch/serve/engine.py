"""Batched serving engine on one device: request batching, prefill, greedy decode.

The port of the JAX package's ``serve/engine.py`` without the mesh: the
weights and the decode state live on one device (the card by default).
Semantics kept from the reference:
  * a wave of at most ``batch_size`` requests; dummy requests (one token 0)
    fill the batch;
  * prompts are right-aligned at the longest prompt's length by LEFT
    padding with token 0, and the pads are attended like any token;
  * one prefill, then greedy argmax decode with every row at the shared
    position ``pos``;
  * it stops when every live request has its tokens, or at ``max_len``.
The decode state is allocated once per wave and updated in place. Each wave
records its timings in :attr:`ServeEngine.last_stats`.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models import decode_step, init_decode_state, prefill
from repro_torch.models.transformer import ArchConfig, LMParams

__all__ = ["ServeEngine", "Request", "ServeStats"]


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int = 16
    output: list[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens


@dataclasses.dataclass
class ServeStats:
    """One wave, on the host clock; every interval ends in a device sync
    (the argmax tokens are copied to the host)."""

    prompt_len: int = 0
    prefill_s: float = 0.0      # prefill and the first tokens' argmax
    decode_s: float = 0.0       # every decode step and its argmax
    decode_steps: int = 0
    decode_tokens: int = 0      # tokens of live requests made by decode steps

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s > 0 else 0.0


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: LMParams, *, batch_size: int = 8,
                 max_len: int = 512, cache_dtype=torch.bfloat16, force=None):
        """``params`` fixes the device; ``force`` is passed to ``ops``
        (``"ref"`` serves through the plain versions of the kernels)."""
        self.cfg, self.params = cfg, params
        self.batch_size, self.max_len = batch_size, max_len
        self.cache_dtype = cache_dtype
        self.force = force
        self.device = params.embed.device
        self.last_stats = ServeStats()

    def _make_batch(self, requests: list[Request]) -> tuple[dict, int]:
        """Right-align prompts at a common length (left pad with 0). The
        stub frontends get zero inputs, as in the reference: the audio
        stub (B, encoder_seq, d) frames, the vision stub (B, min(num_patches,
        plen), d) patches."""
        plen = max(len(r.prompt) for r in requests)
        toks = np.zeros((self.batch_size, plen), np.int64)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt):] = r.prompt
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        cfg = self.cfg
        if cfg.frontend == "audio_stub":
            batch["enc_embeds"] = torch.zeros((self.batch_size, cfg.encoder_seq, cfg.d_model),
                                              device=self.device)
        if cfg.frontend == "vision_stub":
            batch["patch_embeds"] = torch.zeros(
                (self.batch_size, min(cfg.num_patches, plen), cfg.d_model), device=self.device)
        return batch, plen

    @torch.no_grad()
    def serve(self, requests: list[Request]) -> list[Request]:
        """Run a wave of ≤ batch_size requests to completion (greedy)."""
        if len(requests) > self.batch_size:
            raise ValueError(f"{len(requests)} requests > batch_size {self.batch_size}")
        live = list(requests)
        while len(live) < self.batch_size:   # pad the wave with dummies
            live.append(Request(request_id=-1, prompt=np.zeros(1, np.int32)))
        batch, plen = self._make_batch(live)
        if plen > self.max_len:
            raise ValueError(f"prompt length {plen} > max_len {self.max_len}")
        stats = ServeStats(prompt_len=plen)
        t0 = time.perf_counter()
        state = init_decode_state(self.cfg, self.batch_size, self.max_len,
                                  self.cache_dtype, self.device)
        logits, state = prefill(self.cfg, self.params, state, batch, force=self.force)
        pos = plen
        t_decode = None
        for _ in range(max(r.max_new_tokens for r in requests)):
            next_tok = torch.argmax(logits, dim=-1)               # (B,)
            toks = next_tok.tolist()
            if t_decode is None:
                t_decode = time.perf_counter()
                stats.prefill_s = t_decode - t0
            for i, r in enumerate(live):
                if r.request_id >= 0 and not r.done:
                    r.output.append(int(toks[i]))
                    stats.decode_tokens += stats.decode_steps > 0
            if all(r.done for r in live if r.request_id >= 0):
                break
            if pos >= self.max_len:
                break
            logits, state = decode_step(self.cfg, self.params, state, next_tok[:, None],
                                        pos, force=self.force)
            pos += 1
            stats.decode_steps += 1
        if t_decode is not None:
            stats.decode_s = time.perf_counter() - t_decode
        self.last_stats = stats
        return requests
