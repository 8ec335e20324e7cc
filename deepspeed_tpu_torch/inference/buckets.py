"""Shape bucketing for the serving engine.

XLA programs are shape-specialized: a fresh (batch, prompt_len) pair is
a fresh multi-second compile — the classic serving-latency killer. The
engine therefore pads every prefill batch to a configured (batch
bucket, prompt bucket) pair, so steady-state serving dispatches exactly
``len(batch_buckets) × len(prompt_buckets)`` prefill programs plus ONE
decode program, all compiled during warmup — pinned by the engine's
CompileTracker (zero recompiles after warmup is a tier-1 assertion).

Pure host-side helpers; no jax imports.
"""

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["pick_bucket", "validate_buckets", "pad_prompts",
           "warmup_plan", "chunk_warmup_plan"]


def validate_buckets(buckets: Sequence[int], name: str) -> Tuple[int, ...]:
    """Normalize a bucket list: ints, positive, strictly ascending."""
    if not buckets:
        raise ValueError(f"{name} must be a non-empty list of ints")
    out = tuple(int(b) for b in buckets)
    if any(b <= 0 for b in out):
        raise ValueError(f"{name} must be positive, got {list(out)}")
    if list(out) != sorted(set(out)):
        raise ValueError(f"{name} must be strictly ascending "
                         f"(got {list(out)})")
    return out


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n. Raises when n exceeds the largest bucket —
    the caller (scheduler admission / engine submit) surfaces that as a
    rejected request rather than a silent recompile."""
    for b in buckets:
        if n <= b:
            return int(b)
    raise ValueError(f"{n} exceeds the largest bucket {max(buckets)}")


def pad_prompts(prompts: Sequence[Sequence[int]], bucket_len: int,
                bucket_batch: int) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad prompts with 0 into an (bucket_batch, bucket_len) int32
    batch plus true lengths (bucket_batch,) int32. Padding rows (beyond
    ``len(prompts)``) carry length 1 so downstream last-token gathers
    stay in range; their outputs are discarded (the engine scatters
    their cache rows into the scratch slot).
    """
    n = len(prompts)
    if n > bucket_batch:
        raise ValueError(f"{n} prompts exceed batch bucket {bucket_batch}")
    ids = np.zeros((bucket_batch, bucket_len), np.int32)
    lengths = np.ones((bucket_batch,), np.int32)
    for i, p in enumerate(prompts):
        arr = np.asarray(p, np.int32).reshape(-1)
        if arr.size == 0 or arr.size > bucket_len:
            raise ValueError(f"prompt length {arr.size} outside (0, "
                             f"{bucket_len}]")
        ids[i, :arr.size] = arr
        lengths[i] = arr.size
    return ids, lengths


def warmup_plan(batch_buckets: Sequence[int],
                prompt_buckets: Sequence[int]) -> List[Tuple[int, int]]:
    """Every (batch_bucket, prompt_bucket) pair the steady state can
    dispatch — the warmup compile set."""
    return [(int(b), int(s)) for b in batch_buckets for s in prompt_buckets]


def chunk_warmup_plan(batch_buckets: Sequence[int],
                      chunk_tokens: int) -> List[Tuple[int, int]]:
    """The chunked-prefill warmup compile set: one (batch_bucket,
    chunk_tokens) shape per batch bucket. This is the ladder collapse —
    chunked prefill replaces the ``len(batch_buckets) ×
    len(prompt_buckets)`` prompt-bucket grid with a single token width,
    so prompt length stops being a compile axis entirely (any length up
    to max_seq_len is a row count of chunk dispatches, not a new
    program)."""
    if chunk_tokens <= 0:
        return []
    return [(int(b), int(chunk_tokens)) for b in batch_buckets]
