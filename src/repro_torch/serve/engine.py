"""LM serving engine: batched prefill + greedy decode with a static KV
cache (port of ``repro.serve.engine``).

Prompts are left-padded with token 0 into one fixed (max_batch,
prompt_len) batch; ``lm.prefill`` builds the cache (its attention is the
flash kernel on the card), then ``lm.decode_step`` runs once per new
token, updating the cache in place.  Generated tokens stay on the device
and are copied to the host once.  Every duration is read through the
injected ``Clock`` and each timed region ends at
``torch.cuda.synchronize()`` on the card.

Runs on ``device="cuda"`` unless the caller passes ``device="cpu"``;
raises if CUDA is missing.  ``mode`` goes to the attention's kernel
dispatch (``kernels.ops``), as ``GNNEngine``'s does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.serve.clock import Clock, RealClock
from repro_torch.serve.executor import _params_to


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    prompt_len: int = 64  # padded prompt length
    cache_len: int = 256
    max_new_tokens: int = 32


class LMServer:
    def __init__(self, params: dict, cfg: ModelConfig, serve_cfg: ServeConfig,
                 clock: Optional[Clock] = None, device="cuda", mode: str = "auto"):
        """``params`` are moved to ``device`` (no copy when they are there).
        Raises ``ValueError`` when decoding would write past the cache:
        JAX's ``dynamic_update_slice`` clamps such a write onto the last
        slot instead."""
        if serve_cfg.prompt_len + serve_cfg.max_new_tokens > serve_cfg.cache_len:
            raise ValueError(
                f"prompt_len {serve_cfg.prompt_len} + max_new_tokens "
                f"{serve_cfg.max_new_tokens} exceeds cache_len {serve_cfg.cache_len}")
        self.device = resolve_device(device)
        self.params = _params_to(params, self.device)
        self.cfg = cfg
        self.scfg = serve_cfg
        self.mode = mode
        self.clock: Clock = clock if clock is not None else RealClock()

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts: List[np.ndarray]):
        """prompts: list of integer arrays (<= prompt_len each).  Greedy
        decode.  Returns (generated (B, max_new) int32 numpy, stats)."""
        scfg = self.scfg
        b = len(prompts)
        if b > scfg.max_batch:
            raise ValueError(f"{b} prompts for a batch of {scfg.max_batch}")
        toks = np.zeros((scfg.max_batch, scfg.prompt_len), np.int32)
        for i, pr in enumerate(prompts):
            toks[i, -len(pr):] = pr  # left-pad with 0 (simplification)
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        t0 = self.clock.now()
        cache, last_logits, t = lm.prefill(self.params, batch, self.cfg,
                                           scfg.cache_len, kernel_mode=self.mode)
        self._synchronize()
        prefill_s = self.clock.now() - t0
        out = torch.empty((scfg.max_batch, scfg.max_new_tokens), dtype=torch.int32,
                          device=self.device)
        tok = torch.argmax(last_logits, dim=-1).to(torch.int32)[:, None]
        t0 = self.clock.now()
        for i in range(scfg.max_new_tokens):
            out[:, i] = tok[:, 0]
            logits, cache = lm.decode_step(self.params, cache, tok, t, self.cfg)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            t += 1
        self._synchronize()
        decode_s = self.clock.now() - t0
        return out.cpu().numpy()[:b], {
            "prefill_s": prefill_s,
            "decode_s_per_token": decode_s / scfg.max_new_tokens,
        }
