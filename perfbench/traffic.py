"""The one traffic generator: request texts from a mix's parameters.

A mix (``perfbench/mixes/<traffic>.json``) gives the range of phone counts
(``min_phones`` .. ``max_phones``); the configuration gives the vocabulary
of each phone stream (``n_symbols``). Texts are random ``id_tone_er``
tokens drawn from the vocabulary, 0 being padding, as
``msmctts_tpu_torch/tools/load_test.py``'s ``rand_text`` draws them, so that
every request is distinct.

Every seed gets the same multiset of phone counts, in another order: the
requests come in blocks that hold each count of the range once, each block
shuffled by the seed. Any run's requests then carry the same work, however
many the window takes, and only the texts and their order change with the
seed. The texts are drawn in bulk before the window, so that making them
costs the window nothing.
"""

from __future__ import annotations

from typing import List

import numpy as np


def texts(seed: int, traffic: dict, n: int) -> List[np.ndarray]:
    """The first ``n`` request texts of ``seed``, int32 [n_phones, n_streams]."""
    rng = np.random.default_rng(int(seed))
    lo, hi = int(traffic["min_phones"]), int(traffic["max_phones"])
    blocks = -(-n // (hi - lo + 1))
    counts = np.concatenate([rng.permutation(np.arange(lo, hi + 1)) for _ in range(blocks)])[:n]
    ids = np.stack([rng.integers(1, max(int(s), 2), size=int(counts.sum())) for s in traffic["n_symbols"]], axis=-1)
    return np.split(ids.astype(np.int32), np.cumsum(counts)[:-1])
