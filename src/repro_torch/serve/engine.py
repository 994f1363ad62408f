"""LM serving engine: batched prefill + greedy decode with a static KV
cache (port of ``repro.serve.engine``).

Prompts are left-padded with token 0 into one fixed (max_batch,
prompt_len) batch.  JAX compiles two programs, prefill and the decode step
(the cache donated, the position a traced value); the port's counterparts
are two CUDA graphs over static state that the server makes once: the
token batch, the cache, the decode position and step index as device
tensors, the last token and the (max_batch, max_new_tokens) output.

* **prefill** writes the prompt's sequence entries into the cache (K/V,
  or MLA's latent ckv / krope; zero past the prompt, as JAX's fresh cache
  is; its attention is the flash kernel on the card) and the final
  recurrent states (Mamba's conv / ssm, RWKV's shift / wkv / cm_shift),
  takes the first token and resets the position to ``prompt_len`` (after
  a VLM's patches);
* **one decode step** writes the last token into the output at the step
  index, runs ``lm.decode_step`` at the device position (the cache's
  sequence slot and recurrent states updated in place), takes the next
  token and advances position and index on the device.

Both are captured at the first ``generate`` on the card, from one memory
pool, after an eager warm-up of each on the capture stream (kernel builds,
cuBLAS handles and workspace, the flash kernel's attributes); a later
``generate`` captures nothing.  ``generate`` copies the prompt in, replays
prefill, replays the step ``max_new_tokens`` times (JAX's step count) and
copies the output to the host once.  A failed capture or replay raises.
On the CPU (``device="cpu"``) the same two functions run eagerly over the
same state.  Every duration is read through the injected ``Clock`` and
each timed region ends at ``torch.cuda.synchronize()`` on the card.

Every family serves alike: the MoE layers' routing (top-k, the slot
dispatch's sort and gathers) and the recurrences (a loop over the static
prompt length) read nothing back to the host, so the graphs capture them
with the rest; what differs by family is decided in Python before the
capture.  A VLM or audio model takes JAX's ``extras`` beside the prompts
(``patches`` (B, P, d_model) or ``frames`` (B, encoder_seq, d_model),
float32) into one more static buffer, which the captured prefill reads:
a VLM's patches go before the tokens (the decode then starts at P +
``prompt_len``), an audio model's frames through the encoder inside the
prefill graph, whose cross K/V the decode graph reads from the cache.

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
        Raises ``ValueError`` when decoding would write past the cache
        (a VLM's patches count): JAX's ``dynamic_update_slice`` clamps such
        a write onto the last slot instead, and the captured step cannot
        check its device position."""
        patches = cfg.num_patches if cfg.family == "vlm" else 0
        # the first decode position: the prefill's t0
        self.t0 = patches + serve_cfg.prompt_len
        if self.t0 + serve_cfg.max_new_tokens > serve_cfg.cache_len:
            raise ValueError(
                f"{f'{patches} patches + ' if patches else ''}prompt_len "
                f"{serve_cfg.prompt_len} + max_new_tokens "
                f"{serve_cfg.max_new_tokens} exceeds cache_len {serve_cfg.cache_len}")
        self.device = resolve_device(device)
        self.params = _params_to(params, self.device)
        self.cfg = cfg
        self.scfg = serve_cfg
        self.mode = mode
        self.clock: Clock = clock if clock is not None else RealClock()
        b, dev = serve_cfg.max_batch, self.device
        self._tokens = torch.zeros((b, serve_cfg.prompt_len), dtype=torch.int32, device=dev)
        extra = lm.extra_input(cfg, b)  # the family's input beside the tokens
        self._extras = {} if extra is None else {
            extra[0]: torch.zeros(extra[1], dtype=torch.float32, device=dev)}
        self._cache = lm.init_cache(cfg, b, serve_cfg.cache_len, device=dev)
        self._pos = torch.zeros((), dtype=torch.long, device=dev)
        self._step = torch.zeros((), dtype=torch.long, device=dev)
        self._tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        self._out = torch.zeros((b, serve_cfg.max_new_tokens), dtype=torch.int32,
                                device=dev)
        self.prefill_graph: Optional[torch.cuda.CUDAGraph] = None
        self.decode_graph: Optional[torch.cuda.CUDAGraph] = None
        self.captures = 0  # CUDA graphs captured (2 once warm on the card)
        self.capture_seconds = 0.0
        self.pool_bytes = 0  # memory the graphs' pool reserved at capture

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill(self) -> None:
        """The prompt batch (and its extra) into the cache; the first
        token; position t0 (``prompt_len``, after a VLM's patches), step
        index 0."""
        _, last, s = lm.prefill(self.params, {"tokens": self._tokens, **self._extras},
                                self.cfg, self.scfg.cache_len, kernel_mode=self.mode,
                                cache=self._cache)
        self._tok.copy_(torch.argmax(last, dim=-1)[:, None])
        self._pos.fill_(s)
        self._step.zero_()

    def _decode(self) -> None:
        """One greedy step: the last token into the output at the step
        index, the step at the position, the next token; both advance."""
        self._out.index_copy_(1, self._step.reshape(1), self._tok)
        logits, _ = lm.decode_step(self.params, self._cache, self._tok, self._pos,
                                   self.cfg)
        self._tok.copy_(torch.argmax(logits, dim=-1)[:, None])
        self._pos.add_(1)
        self._step.add_(1)

    def _capture(self) -> None:
        """Warm both programs eagerly on a side stream, then capture each
        into a CUDA graph on it, from one memory pool.  The warm-up's
        cached blocks are returned to the card before the capture: they
        stay cached for the side stream in the default pool, which the
        graphs' private pool does not draw from."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        prefill, decode = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(side):
            self._prefill()
            self._decode()
            side.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = self.clock.now()
            for graph, fn in ((prefill, self._prefill), (decode, self._decode)):
                graph.capture_begin(pool=pool)
                try:
                    fn()
                finally:
                    graph.capture_end()
            side.synchronize()
            self.capture_seconds += self.clock.now() - t0
        torch.cuda.current_stream(dev).wait_stream(side)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.prefill_graph, self.decode_graph = prefill, decode
        self.captures += 2

    def _fill_extras(self, extras: Optional[dict], b: int) -> None:
        """Copy the family's extra (rows b .. max_batch; the batch's rows
        past it zeroed) into its static buffer; ValueError if it is
        missing or of another shape."""
        for name, buf in self._extras.items():
            arr = None if extras is None else extras.get(name)
            if arr is None:
                raise ValueError(f"a {self.cfg.family} model needs extras[{name!r}], "
                                 f"{tuple(buf.shape[1:])} a prompt")
            arr = np.asarray(arr, np.float32)
            if arr.shape[1:] != tuple(buf.shape[1:]) or not b <= len(arr) <= len(buf):
                raise ValueError(f"extras[{name!r}] of shape {arr.shape} for {b} "
                                 f"prompts; expected ({b}..{len(buf)}, "
                                 f"{', '.join(map(str, buf.shape[1:]))})")
            buf[:len(arr)].copy_(torch.from_numpy(arr))
            buf[len(arr):].zero_()

    def generate(self, prompts: List[np.ndarray], extras: Optional[dict] = None):
        """prompts: list of integer arrays (<= prompt_len each); extras:
        JAX's, a VLM's "patches" (B, P, d_model) or an audio model's
        "frames" (B, encoder_seq, d_model), required for those families.
        Greedy decode.  Returns (generated (B, max_new) int32 numpy,
        stats)."""
        scfg = self.scfg
        b = len(prompts)
        if b > scfg.max_batch:
            raise ValueError(f"{b} prompts for a batch of {scfg.max_batch}")
        toks = np.zeros((scfg.max_batch, scfg.prompt_len), np.int32)
        for i, pr in enumerate(prompts):
            toks[i, -len(pr):] = pr  # left-pad with 0 (simplification)
        self._fill_extras(extras, b)
        graphs = self.device.type == "cuda"
        if graphs and self.decode_graph is None:
            self._capture()
        prefill = self.prefill_graph.replay if graphs else self._prefill
        step = self.decode_graph.replay if graphs else self._decode
        self._tokens.copy_(torch.from_numpy(toks))
        t0 = self.clock.now()
        prefill()
        self._synchronize()
        prefill_s = self.clock.now() - t0
        t0 = self.clock.now()
        for _ in range(scfg.max_new_tokens):
            step()
        self._synchronize()
        decode_s = self.clock.now() - t0
        return self._out.to("cpu", copy=True).numpy()[:b], {
            "prefill_s": prefill_s,
            "decode_s_per_token": decode_s / scfg.max_new_tokens,
        }
