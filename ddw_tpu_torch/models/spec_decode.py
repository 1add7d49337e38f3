"""Speculative decoding — the port of ``ddw_tpu.models.spec_decode``: draft
proposals verified by the target in one multi-token decode call
(Leviathan et al. 2211.17192, greedy acceptance).

A small draft model proposes ``k`` tokens; the target scores all of them in
one ``S = k + 1`` decode call (the contiguous cache takes multi-token
blocks with causality inside the block), so a round costs one target
forward and ``k`` draft forwards and confirms between 1 and ``k + 1``
tokens. Drafts are accepted while they equal the target's own argmax and
the first disagreement is replaced by the target's pick, so the output is
exactly the target's greedy continuation; the draft changes only latency.

Both caches advance while drafting and verifying and are rewound over
rejected positions by lowering the host ``cache_index`` / ``pos_index``
(K/V beyond an index is never attended and is overwritten by the next write
at that position). :func:`match_length` is the acceptance rule the serving
engine's speculative tick will share.
"""

from __future__ import annotations

import numpy as np
import torch

from ddw_tpu_torch.models.lm import TransformerLM, init_cache

_REWIND_KEYS = ("cache_index", "pos_index")


def match_length(drafts, picks) -> int:
    """Exact-match acceptance: the number of leading draft proposals that
    equal the verifier's own picks at the same positions. Position ``j``'s
    pick is conditioned on drafts ``0..j-1`` all having been accepted, so
    the emitted block ``drafts[:m] + [picks[m]]`` is by induction what
    step-by-step decode with the same picker would have produced."""
    m = 0
    k = min(len(drafts), len(picks))
    while m < k and int(picks[m]) == int(drafts[m]):
        m += 1
    return m


def _rewind(cache: dict, n: int) -> None:
    """Roll a contiguous decode cache back ``n`` positions (its host index
    integers only), in place."""
    for key, val in cache.items():
        if isinstance(val, dict):
            _rewind(val, n)
        elif key in _REWIND_KEYS:
            cache[key] = val - n


def _draft_round(model: TransformerLM, cache: dict, lag: torch.Tensor,
                 k: int) -> list[int]:
    """One drafting round: consume the lag block, then greedy-decode ``k``
    tokens. The picks stay on the device until the round's one fetch."""
    tok = model(lag, cache=cache)[:, -1:].argmax(-1)       # d_1, [1, 1]
    drafts = [tok]
    for _ in range(k - 1):
        tok = model(tok, cache=cache)[:, -1:].argmax(-1)
        drafts.append(tok)
    return [int(t) for t in torch.cat(drafts, 1)[0].cpu()]


@torch.inference_mode()
def generate_speculative(model: TransformerLM, draft_model: TransformerLM,
                         prompt, num_steps: int, k: int = 4):
    """Greedy continuation of ``prompt`` equal to ``generate(model, ...)``
    at temperature 0, produced in draft-verified rounds.

    ``prompt`` is int ``[1, P]`` (per-row acceptance lengths diverge, so
    B > 1 raises). Returns ``(tokens [1, num_steps] int32 on the target's
    device, stats)`` with the rounds, target calls, draft tokens proposed
    and accepted, the acceptance rate and tokens per target call."""
    dev = model.head.kernel.device
    prompt = torch.as_tensor(np.asarray(prompt)).to(device=dev,
                                                    dtype=torch.long)
    b, plen = prompt.shape
    if b != 1:
        raise ValueError(f"speculative decoding is per-sequence (B=1), "
                         f"got batch {b}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if model.vocab_size != draft_model.vocab_size:
        raise ValueError("target and draft must share a vocabulary "
                         f"({model.vocab_size} vs {draft_model.vocab_size})")
    # verification writes up to k unaccepted rows past the confirmed prefix
    # before the rewind; they must stay inside the cache or the overflow
    # NaN poison fires on rows that would later be rolled back
    if plen + num_steps + k + 1 > model.max_len:
        raise ValueError(f"prompt {plen} + steps {num_steps} + lookahead "
                         f"{k + 1} exceeds target max_len {model.max_len}")
    if plen + num_steps + k + 1 > draft_model.max_len:
        raise ValueError(f"prompt {plen} + steps {num_steps} + lookahead "
                         f"{k + 1} exceeds draft max_len "
                         f"{draft_model.max_len}")
    ddev = draft_model.head.kernel.device
    modes = model.training, draft_model.training
    model.eval()
    draft_model.eval()
    try:
        cache_t = init_cache(model, 1)
        cache_d = init_cache(draft_model, 1)
        # the target's last-position argmax is the first confirmed token;
        # the draft prefills all but the last prompt token, its first
        # drafting input next round
        first = int(model(prompt, cache=cache_t)[0, -1].argmax())
        if plen > 1:
            draft_model(prompt[:, :-1].to(ddev), cache=cache_d)
        # H = the confirmed sequence; between rounds the target cache has
        # processed H[:-1], the draft cache H[:p_d] with p_d <= len(H) - 1
        hist = [int(t) for t in prompt[0].cpu()] + [first]
        p_d = plen - 1
        rounds = proposed = accepted_drafts = 0
        while len(hist) - plen < num_steps:
            rounds += 1
            lag = torch.tensor([hist[p_d:]], dtype=torch.long, device=ddev)
            drafts = _draft_round(draft_model, cache_d, lag, k)
            p_d = len(hist) + k - 1        # processed: lag + drafts[:-1]
            block = torch.tensor([[hist[-1]] + drafts], dtype=torch.long,
                                 device=dev)
            preds = model(block, cache=cache_t)[0].argmax(-1).cpu().numpy()
            m = match_length(drafts, preds)
            proposed += k
            accepted_drafts += m
            hist.extend(drafts[:m] + [int(preds[m])])
            _rewind(cache_t, k - m)        # keep inputs t_cur, d_1..d_m
            # the draft processed t_cur, d_1..d_{k-1}; its valid prefix is
            # t_cur..d_m. Full acceptance rewinds nothing: d_k rides in the
            # next round's lag
            rew_d = (k - 1) - m if m < k else 0
            if rew_d:
                _rewind(cache_d, rew_d)
                p_d -= rew_d
    finally:
        model.train(modes[0])
        draft_model.train(modes[1])
    gen = hist[plen:plen + num_steps]
    target_calls = rounds + 1              # verification rounds + prefill
    stats = {"rounds": rounds, "target_calls": target_calls,
             "drafts_proposed": proposed,
             "drafts_accepted": accepted_drafts,
             "acceptance_rate": (accepted_drafts / proposed if proposed
                                 else 0.0),
             "tokens_per_target_call": len(gen) / target_calls}
    return torch.tensor([gen], dtype=torch.int32, device=dev), stats
