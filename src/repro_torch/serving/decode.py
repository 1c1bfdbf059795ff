"""Batched autoregressive serving loop on top of decode_step
(``repro/serving/decode.py``).

``prefill`` feeds a prompt token by token through ``decode_step`` (the
cache-exact path, no kernel), carrying the model's state (the KV cache,
the RWKV state, or hybrid's KV cache with its mamba conv window and ssm
state); prompts are text tokens.  The production prefill is the
full-sequence forward (``training.step.make_prefill_step``), which runs
the kernels.
``generate`` is greedy at temperature 0, else it samples from a
``torch.Generator`` (its numbers are not ``jax.random``'s).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.models import module as m
from repro_torch.models.registry import Model


@torch.no_grad()
def prefill(model: Model, params, tokens: torch.Tensor,
            context_len: int, opts: Optional[dict] = None
            ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Feed a prompt token-by-token through decode_step (cache-exact path).

    Returns (last_logits (B, 1, vocab_padded), state, positions (B,))."""
    B, S = tokens.shape
    dtype = m.dtype_of(model.cfg.dtype)
    state = model.init_decode_state(B, context_len, dtype)
    logits = torch.zeros((B, 1, model.cfg.vocab_padded), dtype=dtype,
                         device=tokens.device)
    for t in range(S):
        pos = torch.full((B,), t, dtype=torch.int32, device=tokens.device)
        logits, state = model.decode(params, tokens[:, t:t + 1], state, pos,
                                     opts)
    return logits, state, torch.full((B,), S, dtype=torch.int32,
                                     device=tokens.device)


@torch.no_grad()
def generate(model: Model, params, prompt: torch.Tensor, max_new: int,
             context_len: int, temperature: float = 0.0,
             gen: Optional[torch.Generator] = None,
             opts: Optional[dict] = None) -> torch.Tensor:
    """Greedy / sampled generation.  prompt: (B, S) -> (B, max_new) int32.

    Sampling draws from ``gen`` (default: a generator seeded 0 on the
    prompt's device, as the reference defaults to ``PRNGKey(0)``)."""
    logits, state, pos = prefill(model, params, prompt, context_len, opts)
    if temperature > 0.0 and gen is None:
        gen = torch.Generator(device=prompt.device).manual_seed(0)

    def pick(lg):
        lg = lg[:, -1].to(torch.float32)
        if temperature <= 0.0:
            return torch.argmax(lg, dim=-1).to(torch.int32)
        probs = torch.softmax(lg / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)

    toks = [pick(logits)]
    for _ in range(max_new - 1):
        logits, state = model.decode(params, toks[-1][:, None], state, pos,
                                     opts)
        pos = pos + 1
        toks.append(pick(logits))
    return torch.stack(toks, dim=1)
