"""Batched serving engine on one device: request batching, prefill, greedy decode.

The port of the JAX package's ``serve/engine.py``: the weights and the
decode state live on one device (the card by default) or, with ``mesh=``
(a ``torch.distributed`` device mesh), on the mesh: the weights as
DTensors per ``param_pspecs``, the decode state per ``state_pspecs``
(batch over dp, KV heads over tp, or the KV sequence over tp where the
heads do not divide it; ``seq_shard`` asks for the sequence), the wave's
tokens over dp. Every rank serves the same wave and reads the same tokens.
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

from repro_torch.data.pipeline import place_batch
from repro_torch.models import decode_step, init_decode_state, params_to_reference, prefill
from repro_torch.models.transformer import ArchConfig, LMParams

__all__ = ["ServeEngine", "Request", "ServeStats"]


def _whole(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


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
                 max_len: int = 512, cache_dtype=torch.bfloat16, force=None,
                 mesh=None, seq_shard: bool | str = False):
        """``params`` fixes the device (:class:`LMParams` or the JAX
        package's tree); ``force`` is passed to ``ops`` (``"ref"`` serves
        through the plain versions of the kernels). With ``mesh`` the
        weights (the same on every rank) are placed on it."""
        self.cfg, self.params, self.mesh = cfg, params, mesh
        self.batch_size, self.max_len = batch_size, max_len
        self.cache_dtype = cache_dtype
        self.force = force
        self.seq_shard = seq_shard
        self.last_stats = ServeStats()
        if mesh is None:
            self.device = params.embed.device if not isinstance(params, dict) \
                else params["embed"].device
            return
        from repro_torch.distributed import sharding as shd
        from repro_torch.train.train_step import data_size_of, distribute_tree

        tree = params_to_reference(cfg, params)
        self.params = distribute_tree(tree, mesh, shd.param_pspecs(tree, fsdp=False))
        self.device = self.params["embed"].device
        self._dp = data_size_of(mesh)
        self._tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)

    def _fresh_state(self) -> list[dict]:
        state = init_decode_state(self.cfg, self.batch_size, self.max_len,
                                  self.cache_dtype, self.device)
        if self.mesh is None:
            return state
        from repro_torch.distributed import sharding as shd
        from repro_torch.train.train_step import distribute_tree

        specs = shd.state_pspecs(state, seq_shard=self.seq_shard, dp_size=self._dp,
                                 tp_size=self._tp)
        return distribute_tree(state, self.mesh, specs)

    def _make_batch(self, requests: list[Request]) -> tuple[dict, int]:
        """Right-align prompts at a common length (left pad with 0). The
        stub frontends get zero inputs, as in the reference: the audio
        stub (B, encoder_seq, d) frames, the vision stub (B, min(num_patches,
        plen), d) patches."""
        plen = max(len(r.prompt) for r in requests)
        toks = np.zeros((self.batch_size, plen), np.int64)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt):] = r.prompt
        batch = {"tokens": toks}
        cfg = self.cfg
        if cfg.frontend == "audio_stub":
            batch["enc_embeds"] = np.zeros((self.batch_size, cfg.encoder_seq, cfg.d_model),
                                           np.float32)
        if cfg.frontend == "vision_stub":
            batch["patch_embeds"] = np.zeros(
                (self.batch_size, min(cfg.num_patches, plen), cfg.d_model), np.float32)
        if self.mesh is not None:
            return place_batch(batch, mesh=self.mesh), plen
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}, plen

    def _tokens(self, toks: torch.Tensor) -> torch.Tensor:
        """The next tokens (B, 1), placed on the mesh as the wave's are."""
        if self.mesh is None:
            return toks
        return place_batch({"tokens": toks.cpu().numpy()}, mesh=self.mesh)["tokens"]

    @torch.no_grad()
    def serve(self, requests: list[Request]) -> list[Request]:
        """Run a wave of ≤ batch_size requests to completion (greedy)."""
        if len(requests) > self.batch_size:
            raise ValueError(f"{len(requests)} requests > batch_size {self.batch_size}")
        if self.mesh is not None:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                return self._serve(requests)
        return self._serve(requests)

    def _serve(self, requests: list[Request]) -> list[Request]:
        live = list(requests)
        while len(live) < self.batch_size:   # pad the wave with dummies
            live.append(Request(request_id=-1, prompt=np.zeros(1, np.int32)))
        batch, plen = self._make_batch(live)
        if plen > self.max_len:
            raise ValueError(f"prompt length {plen} > max_len {self.max_len}")
        stats = ServeStats(prompt_len=plen)
        t0 = time.perf_counter()
        state = self._fresh_state()
        logits, state = prefill(self.cfg, self.params, state, batch, force=self.force)
        pos = plen
        t_decode = None
        for _ in range(max(r.max_new_tokens for r in requests)):
            next_tok = torch.argmax(_whole(logits), dim=-1)       # (B,)
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
            logits, state = decode_step(self.cfg, self.params, state,
                                        self._tokens(next_tok[:, None]), pos, force=self.force)
            pos += 1
            stats.decode_steps += 1
        if t_decode is not None:
            stats.decode_s = time.perf_counter() - t_decode
        self.last_stats = stats
        return requests
