"""An order-free digest of a set of unordered pairs, and its check of a
pair buffer.

Each pair (a, b) of ids below n becomes the key min*n + max, each key
goes through SplitMix64's finaliser, and the digest is the sum mod 2^64.
A pair missing, repeated, swapped for another or given twice in both
orders changes the sum; two different sets give the same digest with a
chance of about 2^-64. The reference and the program's answer are
digested by this one function, so they compare by equality.
"""

import torch

MOD = 1 << 64
_M1 = 0xBF58476D1CE4E5B9 - MOD
_M2 = 0x94D049BB133111EB - MOD

#: The value of a pair slot past the count (the port's ``NO_PAIR``).
NO_PAIR = 0xFFFFFFFF

#: Rows of a pair buffer digested at once.
CHUNK = 1 << 23


def _srl(x, k):
    """Logical right shift of int64 ``x`` by ``k``."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix(x):
    x = x ^ _srl(x, 30)
    x = x * _M1
    x = x ^ _srl(x, 27)
    x = x * _M2
    return x ^ _srl(x, 31)


def key_sum(a, b, n):
    """Sum mod 2^64 of the mixed keys of the pairs (a[i], b[i])."""
    keys = torch.minimum(a, b) * n + torch.maximum(a, b)
    return int(_mix(keys).sum()) % MOD


def check_buffer(pairs, count, n):
    """(digest, bad rows, bad tail slots) of a [capacity, 2] int64 pair
    buffer holding ``count`` pairs. A bad row has an id out of [0, n) or
    a self pair; a bad tail slot is one past the count that is not
    ``NO_PAIR``. Reads the buffer in chunks of ``CHUNK`` rows."""
    k = min(count, pairs.shape[0])
    digest = bad = tail = 0
    for s in range(0, pairs.shape[0], CHUNK):
        rows = pairs[s:s + CHUNK]
        live, rest = rows[:max(0, k - s)], rows[max(0, k - s):]
        if live.shape[0]:
            a, b = live[:, 0], live[:, 1]
            bad += int(((a < 0) | (a >= n) | (b < 0) | (b >= n)
                        | (a == b)).sum())
            digest += key_sum(a, b, n)
        if rest.shape[0]:
            tail += int((rest != NO_PAIR).sum())
    return digest % MOD, bad, tail
