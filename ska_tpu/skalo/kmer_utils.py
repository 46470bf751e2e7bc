"""Python-int k-mer helpers for skalo (2-bit codes A=0 C=1 T=2 G=3)."""

_DECODE = "ACTG"
_ENCODE = {c: i for i, c in enumerate(_DECODE)}
_ENCODE.update({c.lower(): i for i, c in enumerate(_DECODE)})

# degenerate middle-base expansion (input.rs:32-51); list order is the
# deterministic replacement for the reference's HashMap iteration
DEGENERATE = {
    "A": ["A"],
    "T": ["T"],
    "G": ["G"],
    "C": ["C"],
    "M": ["A", "C"],
    "S": ["C", "G"],
    "W": ["A", "T"],
    "R": ["A", "G"],
    "Y": ["C", "T"],
    "K": ["G", "T"],
    "B": ["C", "G", "T"],
    "D": ["A", "G", "T"],
    "H": ["A", "C", "T"],
    "V": ["A", "C", "G"],
    "N": ["A", "C", "G", "T"],
}


def encode_str(s: str) -> int:
    v = 0
    for c in s:
        v = (v << 2) | ((ord(c) >> 1) & 3)
    return v


def decode_int(v: int, k: int) -> str:
    out = []
    for i in range(k):
        out.append(_DECODE[(v >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


def rev_comp_int(v: int, k: int) -> int:
    out = 0
    for _ in range(k):
        out = (out << 2) | ((v & 3) ^ 2)
        v >>= 2
    return out


def combine_kmers(k1: int, k2: int) -> int:
    """(k1 << 2) | (k2 & 3) (bit_encoding.rs:133-144)."""
    return (k1 << 2) | (k2 & 3)


def last_nucl(v: int) -> str:
    return _DECODE[v & 3]


def rev_compl_str(seq: str) -> str:
    comp = {"A": "T", "C": "G", "T": "A", "G": "C"}
    return "".join(comp[c] for c in reversed(seq))


def popcount(mask: int) -> int:
    return bin(mask).count("1")


# ---- numpy bulk helpers (vectorized build_graph) ------------------------------

import numpy as np

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_M8 = np.uint64(0x00FF00FF00FF00FF)
_M16 = np.uint64(0x0000FFFF0000FFFF)
_COMP = np.uint64(0xAAAAAAAAAAAAAAAA)


def _rev64_np(x):
    """Reverse the 32 2-bit groups of each uint64 (bit_encoding.rs:182-195).

    Two scratch buffers instead of ~25 temporaries: on fault-slow hosts
    the naive chain's fresh allocations dominate, and this
    runs over multi-million-element planes in the skalo expansion."""
    x = np.asarray(x)
    r = x.astype(np.uint64, copy=True)
    t = np.empty_like(r)
    for s, m in (
        (np.uint64(2), _M2),
        (np.uint64(4), _M4),
        (np.uint64(8), _M8),
        (np.uint64(16), _M16),
    ):
        np.right_shift(r, s, out=t)
        np.bitwise_and(t, m, out=t)
        np.bitwise_and(r, m, out=r)
        np.left_shift(r, s, out=r)
        np.bitwise_or(t, r, out=r)
    np.right_shift(r, np.uint64(32), out=t)
    np.left_shift(r, np.uint64(32), out=r)
    np.bitwise_or(t, r, out=r)
    return r


def rev_comp_np64(x, n_bases: int):
    """Vectorized rev_comp_int for values packed in a single uint64."""
    return (_rev64_np(x) ^ _COMP) >> np.uint64(64 - 2 * n_bases)


def shr2(hi, lo, s: int):
    if s == 0:
        return hi, lo
    if s < 64:
        return hi >> np.uint64(s), (lo >> np.uint64(s)) | (hi << np.uint64(64 - s))
    return np.zeros_like(hi), hi >> np.uint64(s - 64)


def shl2(hi, lo, s: int):
    if s == 0:
        return hi, lo
    if s < 64:
        return (hi << np.uint64(s)) | (lo >> np.uint64(64 - s)), lo << np.uint64(s)
    return lo << np.uint64(s - 64), np.zeros_like(lo)


def rev_comp2(hi, lo, n_bases: int):
    rhi = _rev64_np(lo) ^ _COMP
    rlo = _rev64_np(hi) ^ _COMP
    return shr2(rhi, rlo, 128 - 2 * n_bases)


def to_obj_ints(hi, lo):
    """(hi, lo) uint64 arrays -> flat list of python ints."""
    if hi is None or not hi.any():
        return lo.tolist()
    return ((hi.astype(object) << 64) | lo.astype(object)).tolist()


_DECB = np.frombuffer(b"ACTG", dtype=np.uint8)


class LazySeq:
    """A bubble path's DNA string, materialized on demand.

    A path sequence = decode(entry k-mer) + last base of each later node
    (read_graph.rs:197-213). Most variant groups only ever read small
    windows around candidate SNP positions, so the full string (often
    kilobases, hundreds of thousands of paths) is built only when needed.
    Stores the tail as 2-bit codes (1 byte per node).
    """

    __slots__ = ("head", "_tail", "_parts", "_n", "_s")

    def __init__(self, head: str, tail_codes=None, parts=None, n=None):
        """tail_codes: np.uint8 codes (node & 3) of nodes[1:]; or `parts`,
        a list of code arrays for all nodes (first element dropped when
        the tail materializes) with n = total node count. `parts` may
        also be a zero-arg callable returning that list (core._SegParts),
        deferring even the part-list construction until the tail is
        actually read."""
        self.head = head
        self._tail = tail_codes
        self._parts = parts
        self._n = (len(tail_codes) + 1) if tail_codes is not None else n
        self._s = None

    @property
    def tail(self):
        if self._tail is None:
            parts = self._parts() if callable(self._parts) else self._parts
            self._tail = np.concatenate(parts)[1:]
            self._parts = None
        return self._tail

    def __len__(self):
        return len(self.head) + self._n - 1

    def __str__(self):
        if self._s is None:
            self._s = self.head + _DECB[self.tail].tobytes().decode()
        return self._s

    def __getitem__(self, i):
        if self._s is not None:
            return self._s[i]
        kg = len(self.head)
        n = kg + len(self.tail)
        if isinstance(i, slice):
            a, b, step = i.indices(n)
            if step != 1:
                return str(self)[i]
            if b <= kg:
                return self.head[a:b]
            if a >= kg:
                return _DECB[self.tail[a - kg : b - kg]].tobytes().decode()
            return self.head[a:] + _DECB[self.tail[: b - kg]].tobytes().decode()
        if i < 0:
            i += n
        if i < kg:
            return self.head[i]
        return _DECODE[self.tail[i - kg]]

    def codes(self):
        """2-bit codes of the whole sequence as np.uint8."""
        hc = ((np.frombuffer(self.head.encode(), dtype=np.uint8) >> 1) & 3).astype(
            np.uint8
        )
        return np.concatenate([hc, self.tail])
