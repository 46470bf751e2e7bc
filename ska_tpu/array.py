"""Static multi-sample split k-mer array (the `.skf` content).

Counterpart of reference MergeSkaArray (src/merge_ska_array.rs:108-126):
rows are split k-mers (kept sorted by packed key here, which hashmaps
could not guarantee), columns are samples, values are ASCII IUPAC middle
bases with b'-' for missing. Supports filter / delete / weed / distances /
alignment output / nk introspection.
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np

from . import __version__
from .constants import (
    FILTER_NOAMBIG,
    FILTER_NOAMBIGORCONST,
    FILTER_NOCONST,
    FILTER_NOFILTER,
)
from .encoding import BASE_PROB, IS_AMBIGUOUS, decode_packed
from .ops import npkeys as K

_GAP = ord("-")


@dataclass
class SkaArray:
    k: int
    rc: bool
    names: List[str]
    keys: np.ndarray  # (n, W) uint64 sorted lexicographically
    variants: np.ndarray  # (n, s) uint8 ASCII
    counts: np.ndarray  # (n,) non-missing count per row; any integer
    # dtype whose range covers n_samples (loads keep the byte-narrow
    # decode's uint8 to skip a 8x-widening copy; consumers only
    # compare/index/re-derive it)
    ska_version: str = __version__

    # --- basic accessors -------------------------------------------------

    @property
    def ksize(self) -> int:
        return self.variants.shape[0]

    @property
    def nsamples(self) -> int:
        return self.variants.shape[1]

    @property
    def kbits(self) -> int:
        return 64 * self.keys.shape[1]

    def n_sample_kmers(self):
        return (self.variants != _GAP).sum(axis=0)

    def copy_like(self) -> "SkaArray":
        """Deep copy (filters mutate in place)."""
        return SkaArray(
            k=self.k,
            rc=self.rc,
            names=list(self.names),
            keys=self.keys.copy(),
            variants=self.variants.copy(),
            counts=self.counts.copy(),
            ska_version=self.ska_version,
        )

    def sorted_view(self):
        """(sorted_keys, row_permutation) for binary-search lookups.

        Row storage order is user-visible (alignment column order), so the
        array itself is not reordered.

        This framework's own .skf files store keys already sorted (the
        merge pipeline is sort-based, io/skf.py keeps that order), so a
        single vectorized sortedness check usually replaces the
        O(N log N) argsort; reference-written or row-filtered arrays
        fall back to the full lexsort.

        Treat the returned key array as READ-ONLY: the fast path aliases
        self.keys (a zero-copy, non-writeable view) while the fallback
        returns a fresh copy — mutating either would corrupt or silently
        desync the SkaArray.
        """
        if K.np_lex_is_sorted(self.keys):
            # perm=None means identity: callers index rows directly, so
            # the already-sorted case allocates nothing (this rig's
            # page-fault weather makes even one 4M arange measurable)
            view = self.keys.view()
            view.flags.writeable = False
            return view, None
        perm = K.np_lex_argsort(self.keys)
        return self.keys[perm], perm

    # --- row/column maintenance (merge_ska_array.rs:139-163) -------------

    def _take_rows(self, mask):
        self.keys = self.keys[mask]
        self.variants = self.variants[mask]
        self.counts = self.counts[mask]

    def update_counts(self, filter_ambig_as_missing: bool):
        """Recount non-missing per row, dropping empty rows
        (merge_ska_array.rs:139-163)."""
        counts = None
        try:
            from .io import native
        except Exception:  # noqa: BLE001 - no toolchain: numpy below
            native = None
        if native is not None:
            # one matrix read, no bool-matrix/mask/sum temporaries
            counts = native.update_counts(
                self.variants, filter_ambig_as_missing,
                IS_AMBIGUOUS.view(np.uint8))
        if counts is None:
            present = self.variants != _GAP
            if filter_ambig_as_missing:
                present &= ~IS_AMBIGUOUS[self.variants]
            counts = present.sum(axis=1).astype(np.int64)
        keep = counts > 0
        self.counts = counts
        self._take_rows(keep)

    def delete_samples(self, del_names):
        """Remove named samples, update counts, drop empty rows
        (merge_ska_array.rs:231-271)."""
        if len(del_names) == 0 or len(del_names) == self.nsamples:
            raise ValueError("Invalid number of samples to remove")
        del_set = set(del_names)
        keep_cols = []
        new_names = []
        for idx, name in enumerate(self.names):
            if name in del_set:
                del_set.discard(name)
            else:
                keep_cols.append(idx)
                new_names.append(name)
        if del_set:
            raise ValueError(f"Could not find sample(s): {sorted(del_set)}")
        self.variants = self.variants[:, keep_cols]
        self.names = new_names
        self.update_counts(False)

    # --- site filters (merge_ska_array.rs:289-402) ------------------------

    def filter(
        self,
        min_count: int,
        filter_ambig_as_missing: bool,
        filter_type: str,
        mask_ambig: bool,
        ignore_const_gaps: bool,
        update_kmers: bool = True,
    ) -> int:
        """Row filters; returns number of removed sites."""
        if filter_ambig_as_missing:
            self.update_counts(True)

        v = self.variants
        n = self.ksize

        try:
            from .io import native
        except Exception:  # noqa: BLE001 - no toolchain: numpy below
            native = None
        if native is not None:
            # fused count-threshold + predicate in one matrix pass
            # (csrc/host_build.cpp ska_filter_keep); the numpy chain
            # below stays as the toolchain-free fallback
            keep = native.filter_keep(
                v, self.counts, min_count, filter_type,
                ignore_const_gaps, IS_AMBIGUOUS.view(np.uint8))
            if keep is not None:
                removed = int(n - keep.sum())
                self._take_rows(keep)
                if mask_ambig:
                    amb = IS_AMBIGUOUS[self.variants]
                    self.variants = np.where(
                        amb, np.uint8(ord("N")), self.variants)
                return removed

        keep = self.counts >= min_count

        if filter_type == FILTER_NOFILTER:
            pred = np.ones(n, dtype=bool)
        elif filter_type == FILTER_NOCONST:
            considered = np.ones_like(v, dtype=bool)
            if ignore_const_gaps:
                considered = v != _GAP
            # >1 distinct considered value
            big = np.where(considered, v.astype(np.int16), -1)
            row_max = big.max(axis=1)
            has_two = (
                np.where(considered, v.astype(np.int16), np.int16(32767)).min(axis=1)
                != row_max
            ) & (row_max >= 0)
            pred = has_two
        elif filter_type == FILTER_NOAMBIG:
            pred = ~IS_AMBIGUOUS[v].any(axis=1)
        elif filter_type == FILTER_NOAMBIGORCONST:
            # count distinct unambiguous classes (+ gap unless ignored) > 1
            pres = np.zeros(n, dtype=np.int32)
            for c in b"ACGTU":
                pres += (v == c).any(axis=1)
            if not ignore_const_gaps:
                pres += (v == _GAP).any(axis=1)
            pred = pres > 1
        else:
            raise ValueError(f"Unknown filter {filter_type}")

        keep &= pred
        removed = int(n - keep.sum())
        self._take_rows(keep)

        if mask_ambig:
            amb = IS_AMBIGUOUS[self.variants]
            self.variants = np.where(amb, np.uint8(ord("N")), self.variants)
        return removed

    # --- weed (merge_ska_array.rs:452-487) --------------------------------

    def weed(self, weed_keys: np.ndarray, reverse: bool):
        """Remove rows whose key is in weed_keys (or keep only those)."""
        if len(weed_keys):
            wk = np.unique(np.asarray(weed_keys, dtype=np.uint64), axis=0)
            # self.keys sorted: membership via searchsorted on weed set
            found = _np_member(self.keys, wk)
        else:
            found = np.zeros(self.ksize, dtype=bool)
        keep = found if reverse else ~found
        self._take_rows(keep)

    # --- alignment output (merge_ska_array.rs:499-517) ---------------------

    def write_fasta(self, fh):
        from .io.fastx import write_fasta

        vt = np.ascontiguousarray(self.variants.T)
        for name, row in zip(self.names, vt):
            write_fasta(name, row.tobytes(), fh)

    # --- nk output (merge_ska_array.rs:649-698) ----------------------------

    def nk_display(self) -> str:
        rc = "true" if self.rc else "false"
        names = ", ".join(f'"{n}"' for n in self.names)
        kmers = ", ".join(str(int(x)) for x in self.n_sample_kmers())
        return (
            f"ska_version={self.ska_version}\n"
            f"k={self.k}\n"
            f"k_bits={self.kbits}\n"
            f"rc={rc}\n"
            f"k-mers={self.ksize}\n"
            f"samples={self.nsamples}\n"
            f"sample_names=[{names}]\n"
            f"sample_kmers=[{kmers}]\n"
        )

    def nk_full_info(self) -> str:
        # vectorized decode: fixed-width output rows (upper \t lower \t
        # comma-joined bases \n) assembled as one uint8 matrix — the
        # per-row python loop cost ~73s on a 4.5M-k-mer array
        from .encoding import LETTER_CODE

        half = (self.k - 1) // 2
        kb = self.k - 1
        n = self.ksize
        if n == 0:
            return ""
        W = self.keys.shape[1]
        hi = self.keys[:, 0] if W == 2 else np.zeros(n, np.uint64)
        lo = self.keys[:, W - 1]
        lut = np.frombuffer(bytes(LETTER_CODE[:4]), dtype=np.uint8)
        chars = np.empty((n, kb), np.uint8)
        for j in range(kb):
            bits = 2 * (kb - 1 - j)
            if bits >= 64:
                c = (hi >> np.uint64(bits - 64)) & np.uint64(3)
            elif bits > 0:
                c = ((lo >> np.uint64(bits)) | (hi << np.uint64(64 - bits))) & np.uint64(3)
            else:
                c = lo & np.uint64(3)
            chars[:, j] = lut[c.astype(np.int64)]
        S = self.nsamples
        width = kb + 2 + (2 * S - 1) + 1
        out = np.empty((n, width), np.uint8)
        out[:, :half] = chars[:, :half]
        out[:, half] = 9  # \t
        out[:, half + 1 : kb + 1] = chars[:, half:]
        out[:, kb + 1] = 9
        out[:, kb + 2 : kb + 1 + 2 * S : 2] = self.variants
        if S > 1:
            out[:, kb + 3 : kb + 1 + 2 * S : 2] = ord(",")
        out[:, -1] = 10  # \n
        return out.tobytes().decode()

    # --- distances (merge_ska_array.rs:416-438, 587-632) -------------------

    def distance(self, constant: float, filt_ambig: bool):
        """Pairwise distances via a 16-class Gram matrix product.

        Per-site work in the reference (variant_dist,
        merge_ska_array.rs:587-632) depends only on the pair of 4-bit
        base-set classes, so pair statistics are linear functionals of
        the class-cooccurrence counts G[i,a,j,b] — one big matmul.
        """
        from .distance import pairwise_stats

        return pairwise_stats(self.variants, constant, filt_ambig)


def _np_member(keys: np.ndarray, sorted_set: np.ndarray) -> np.ndarray:
    """Membership of (n, W) keys in sorted unique (m, W) set."""
    if sorted_set.ndim == 1:
        sorted_set = sorted_set[:, None]
    n, W = keys.shape
    if len(sorted_set) == 0:
        # guard BEFORE indexing: clip(idx, 0, -1) would fancy-index row
        # -1 of a 0-row array and raise, so an empty set must short-
        # circuit to the all-False mask it logically is
        return np.zeros(n, dtype=bool)
    if W == 1:
        idx = np.searchsorted(sorted_set[:, 0], keys[:, 0])
        idx = np.clip(idx, 0, len(sorted_set) - 1)
        return sorted_set[idx, 0] == keys[:, 0]
    # two-limb: combine into python-object free comparison via structured sort
    comb_set = _combine128(sorted_set)
    comb_q = _combine128(keys)
    idx = np.clip(np.searchsorted(comb_set, comb_q), 0, len(comb_set) - 1)
    return comb_set[idx] == comb_q


def _combine128(arr):
    """(n, 2) uint64 -> sortable void/structured scalar preserving lex order."""
    a = np.ascontiguousarray(arr.astype(">u8"))
    return a.view([("v", "S16")])["v"].ravel()
