"""Beam-search decoding over a cached step function.

The port's copy of vitxtgqa_tpu/ops/beam_search.py (reference:
pythia/utils/text_utils.py:190-295 ships an eager BeamSearch, unused by the
videoqa path), in plain PyTorch: a loop of ``max_len`` steps over static
shapes.

The step function's contract is the JAX one:
  step_fn(tokens [B], state, t) -> (logits [B, V], state)
with ``state`` a tensor or a (nested) tuple / list / dict of tensors whose
leading dim is B = batch * beams.  Only beam 0 starts alive, so the first
expansion is unbiased; a finished beam extends with EOS at no cost; ties
in the top-k go to the lower flat index (jax.lax.top_k's order).
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

NEG = -1e9


def _gather_state(state: Any, idx: torch.Tensor) -> Any:
    if torch.is_tensor(state):
        return state[idx]
    if isinstance(state, dict):
        return {k: _gather_state(v, idx) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_gather_state(v, idx) for v in state)
    return state


def _topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties to the lower index."""
    order = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, order), order


def beam_search(step_fn: Callable, init_state: Any, batch: int, num_beams: int, bos_id: int,
                eos_id: int, max_len: int,
                length_penalty: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens [batch, num_beams, max_len] best first, scores [batch,
    num_beams])."""
    bb = batch * num_beams
    device = next((t.device for t in _leaves(init_state)), torch.device("cpu"))
    tokens = torch.full((batch, num_beams, max_len + 1), bos_id, dtype=torch.int64,
                        device=device)
    scores = torch.where(torch.arange(num_beams, device=device) == 0, 0.0, NEG)
    scores = scores.to(torch.float32).repeat(batch, 1)
    finished = torch.zeros(batch, num_beams, dtype=torch.bool, device=device)
    state = init_state
    for t in range(max_len):
        logits, state = step_fn(tokens[:, :, t].reshape(bb), state, t)
        v = logits.shape[-1]
        logprobs = torch.log_softmax(logits.float(), dim=-1).reshape(batch, num_beams, v)
        pad_row = torch.full((v,), NEG, device=device)
        pad_row[eos_id] = 0.0
        logprobs = torch.where(finished[:, :, None], pad_row, logprobs)
        top_scores, top_idx = _topk((scores[:, :, None] + logprobs).reshape(batch, -1),
                                    num_beams)
        beam_idx, tok_idx = top_idx // v, top_idx % v
        # reorder the histories by parent beam and append the new token
        tokens = torch.gather(tokens, 1, beam_idx[:, :, None].expand(-1, -1, max_len + 1))
        tokens[:, :, t + 1] = tok_idx
        finished = torch.gather(finished, 1, beam_idx) | (tok_idx == eos_id)
        # reorder the cached state along the folded (batch * beams) dim
        gather = (torch.arange(batch, device=device)[:, None] * num_beams + beam_idx)
        state = _gather_state(state, gather.reshape(bb))
        scores = top_scores
    if length_penalty:
        lengths = (tokens[:, :, 1:] != eos_id).sum(-1) + 1
        scores = scores / lengths.to(torch.float32) ** length_penalty
        order = torch.argsort(-scores, dim=1, stable=True)
        tokens = torch.gather(tokens, 1, order[:, :, None].expand(-1, -1, max_len + 1))
        scores = torch.gather(scores, 1, order)
    return tokens[:, :, 1:], scores


def _leaves(state: Any):
    if torch.is_tensor(state):
        yield state
    elif isinstance(state, dict):
        for v in state.values():
            yield from _leaves(v)
    elif isinstance(state, (list, tuple)):
        for v in state:
            yield from _leaves(v)
