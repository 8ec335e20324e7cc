"""Host-side draft-token proposers for speculative decoding (the port of
``deepspeed_tpu/inference/draft.py``).

Speculative decoding amortizes decode dispatches: instead of one
compiled dispatch per generated token, a cheap *drafter* proposes up to
``k`` continuation tokens and the target model verifies all of them in
ONE seq-``k+1`` dispatch through the paged cached forward
(``inference/engine.py`` ``_verify_paged_impl``). Tokens are accepted
greedily-left-to-right while each draft matches what the target would
have sampled at that position; the first mismatch rolls the rest back —
on the paged KV pool that rollback is free (a position clamp: the
rejected positions' K/V writes sit beyond the clamped ``cache_position``
where the causal cache mask hides them, and the next dispatch's
contiguous writes overwrite them before any query can attend them).

The built-in drafter is **prompt-lookup / n-gram** (no second model):
find the most recent earlier occurrence of the current suffix n-gram in
the request's own history (prompt + generated tokens) and propose the
tokens that followed it. On repetitive workloads — code, templated
text, summarization quoting its source — this accepts several tokens
per dispatch with zero extra device work. :class:`CallableDrafter`
wraps an arbitrary ``fn(history, k) -> tokens`` for a small draft
model; the *scheduler-side* contract is identical either way.

Like the scheduler/paging/bucket modules, this is pure host code:
nothing here imports torch — drafting adds zero device dispatches
and cannot perturb the engine's fixed program set
(``inference/programs.py``).
"""

from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["NGramDrafter", "CallableDrafter", "make_drafter"]


class NGramDrafter:
    """Prompt-lookup drafting: propose the continuation of the most
    recent earlier occurrence of the history's trailing n-gram.

    Matches are tried longest-first (``ngram_max`` down to
    ``ngram_min``): a longer suffix match is stronger evidence the
    history is repeating, so its continuation is proposed first. The
    scan walks backwards so the MOST RECENT occurrence wins (recency
    beats frequency for serving workloads — the active pattern is the
    one being generated right now). Returns ``[]`` when no suffix
    recurs: the engine then falls back to plain one-token decode for
    that slot (a "draft stall" — traced, never an error).
    """

    def __init__(self, k: int = 4, ngram_min: int = 1,
                 ngram_max: int = 3):
        if k < 1:
            raise ValueError("k must be >= 1")
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError("need 1 <= ngram_min <= ngram_max")
        self.k = int(k)
        self.ngram_min = int(ngram_min)
        self.ngram_max = int(ngram_max)

    def propose(self, history: Sequence[int],
                k: Optional[int] = None) -> List[int]:
        """Up to ``k`` draft tokens continuing ``history`` (the
        request's prompt + all kept tokens, pending included)."""
        k = self.k if k is None else min(int(k), self.k)
        h = list(history)
        L = len(h)
        if k < 1 or L < 2:
            return []
        for n in range(min(self.ngram_max, L - 1), self.ngram_min - 1,
                       -1):
            tail = h[L - n:]
            # most recent earlier occurrence of the suffix n-gram;
            # i + n < L so at least one continuation token exists
            for i in range(L - n - 1, -1, -1):
                if h[i:i + n] == tail:
                    return h[i + n:i + n + k]
        return []


class CallableDrafter:
    """An injected draft model behind the same ``propose`` surface.

    ``fn(history, k)`` may be anything — a distilled model, a trie over
    a corpus, a grammar — as long as it returns at most ``k`` candidate
    int tokens synchronously on the host. The engine treats its output
    exactly like n-gram drafts: every token is verified by the target
    before it is kept, so a bad drafter can only cost acceptance rate,
    never correctness.
    """

    def __init__(self, fn: Callable[[Sequence[int], int], Sequence[int]],
                 k: int = 4):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.fn = fn
        self.k = int(k)

    def propose(self, history: Sequence[int],
                k: Optional[int] = None) -> List[int]:
        k = self.k if k is None else min(int(k), self.k)
        if k < 1:
            return []
        out = [int(t) for t in self.fn(history, k)]
        return out[:k]


def make_drafter(spec_cfg: Dict, draft_fn: Optional[Callable] = None):
    """Build the drafter a parsed ``inference.spec_decode`` section asks
    for (None when the section is disabled). ``method: "callable"``
    requires ``draft_fn`` (the engine's ``draft_fn=`` constructor
    argument)."""
    if not spec_cfg.get("enabled", False):
        return None
    method = spec_cfg.get("method", "ngram")
    k = int(spec_cfg.get("k", 4))
    if method == "ngram":
        return NGramDrafter(k=k,
                            ngram_min=int(spec_cfg.get("ngram_min", 1)),
                            ngram_max=int(spec_cfg.get("ngram_max", 3)))
    if method == "callable":
        if draft_fn is None:
            raise ValueError(
                "spec_decode.method 'callable' needs a draft_fn "
                "(pass draft_fn= to the engine)")
        return CallableDrafter(draft_fn, k=k)
    raise ValueError(f"unknown spec_decode.method {method!r}")
