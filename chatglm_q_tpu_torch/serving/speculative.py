"""Prompt-lookup speculative decoding (n-gram drafting, greedy-exact): a
copy of chatglm_q_tpu/serving/speculative.py, used by ``GLMDecoder``.

Drafts come from the sequence itself: the last ``ngram`` tokens are searched
in the prompt + generation history, and the tokens that followed their
previous occurrence become the draft.  One chunked forward verifies them
all; for greedy decoding the accepted prefix is exactly what step-by-step
greedy would emit, so acceptance changes only the number of device steps.
The KV written for rejected positions sits above the rolled-back length and
is overwritten by later steps.
"""
from __future__ import annotations

from typing import Optional, Sequence


def find_draft(history: Sequence[int], ngram: int = 3, k: int = 8,
               min_ngram: int = 1) -> Optional[list]:
    """Draft the ``k`` tokens that followed the most recent earlier
    occurrence of the longest matching tail n-gram (tries ``ngram`` down
    to ``min_ngram``).  Returns None when no n-gram recurs."""
    n = len(history)
    for g in range(min(ngram, n - 1), min_ngram - 1, -1):
        tail = tuple(history[n - g:])
        # most recent earlier occurrence wins
        for s in range(n - g - 1, -1, -1):
            if tuple(history[s : s + g]) == tail:
                nxt = history[s + g : s + g + k]
                if nxt:
                    return list(nxt)
                break
    return None


def greedy_accept(draft: Sequence[int], row_argmax: Sequence[int]) -> int:
    """Longest accepted prefix: ``row_argmax[i]`` is the model's next token
    after the context + draft[:i] and judges ``draft[i]``.  Returns the
    accept count."""
    a = 0
    while a < len(draft) and row_argmax[a] == draft[a]:
        a += 1
    return a
