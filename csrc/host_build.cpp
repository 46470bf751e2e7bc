// Native host-mode `ska build` engine (FASTA path).
//
// The framework's product path is the device pipeline; host mode
// (SKA_PLATFORM=cpu) is the availability fallback, and running the
// sort-based XLA program on a 1-core CPU loses to the reference's
// hashmap design. This engine
// gives the fallback the same data-structure class the reference uses —
// rolling extraction + swisstable/ahash-style flat maps — while
// producing output BYTE-IDENTICAL to the device pipeline:
//
//   * emission rule incl. the build-vs-roll "last window of a record"
//     quirk (reference split_kmer.rs:78-140 build requires idx+k < L;
//     rolls may reach the final base) — records are delimited by one
//     0x00 byte in the flat batch (ska_tpu/io/fastx.py build_batch)
//   * per-base validity: reject N/n ((c & 0xF) == 14) and the 0x00
//     separator (bit_encoding.rs:52-54 + batch padding convention)
//   * canonical min(fwd, rc) on the SPLIT key, middle code flipped on
//     rc (split_kmer.rs:281-295); 2-bit code = (c >> 1) & 3
//   * palindrome W/S sets: key == rc(key) => set gains bit (mid ^ 2)
//     (ska_dict.rs:85-113; encoding.py SET_TO_ASCII "-ACMTWYHGRSVKDBN")
//   * per-(key, sample) IUPAC union = OR of 4-bit sets; zeros -> '-'
//   * global row order: keys sorted ascending (lex over (hi, lo) for
//     k > 31), exactly the device merge's order
//
// FASTQ inputs (quality gates, min-count rank filter) keep the existing
// paths; the caller only routes FASTA cohorts here.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <thread>
#include <vector>
#include <chrono>
#include <cstdio>

namespace {

static inline uint64_t hb_mix(uint64_t x) {
    const unsigned __int128 m =
        (unsigned __int128)(x ^ 0x243f6a8885a308d3ull) * 0x13198a2e03707344ull;
    return (uint64_t)m ^ (uint64_t)(m >> 64);
}

typedef unsigned __int128 u128;

static inline uint64_t key_hash(uint64_t k) { return hb_mix(k); }
static inline uint64_t key_hash(u128 k) {
    return hb_mix((uint64_t)k ^ hb_mix((uint64_t)(k >> 64)));
}

// key -> uint32 payload open-addressing map (0.75 load factor).
// Interleaved {key, val} slots: one cache line per probe instead of the
// three (keys/vals/used) the SoA layout cost — the maps here are tens of
// MB, so every probe is a miss and the line count is the wall time.
// Occupancy sentinel: all-ones key. A split k-mer key drops the middle
// base, so its value is < 2^(2(k-1)) <= 2^124 — the all-ones pattern
// cannot occur for any supported k (split_kmer.rs:281-295).
template <class K>
struct Map {
    struct Slot {
        K key;
        uint32_t val;
    };
    static constexpr K EMPTY = (K)~(K)0;
    std::vector<Slot> t;
    size_t mask = 0, count = 0, limit = 0;
    bool oom = false;

    explicit Map(size_t cap0 = 1 << 12) { rehash(cap0); }

    void rehash(size_t cap) {
        std::vector<Slot> old;
        old.swap(t);
        try {
            t.assign(cap, Slot{EMPTY, 0});
        } catch (const std::bad_alloc&) {
            oom = true;
            return;
        }
        mask = cap - 1;
        limit = cap - cap / 4;
        count = 0;
        // lookahead prefetch: re-inserts are random placements into the
        // fresh (cold) table
        const size_t on = old.size();
        for (size_t i = 0; i < on; i++) {
            if (i + 16 < on && old[i + 16].key != EMPTY)
                __builtin_prefetch(&t[key_hash(old[i + 16].key) & mask]);
            const Slot& s = old[i];
            if (s.key == EMPTY) continue;
            size_t j = key_hash(s.key) & mask;
            while (t[j].key != EMPTY) j = (j + 1) & mask;
            t[j] = s;
            count++;
        }
    }

    // address of the primary slot for k under the CURRENT mask (prefetch
    // target; a rehash between prefetch and insert only wastes the hint)
    const void* primary(K k) const { return &t[key_hash(k) & mask]; }

    // pointer to payload slot; *fresh set when newly inserted (payload 0)
    uint32_t* slot(K k, bool* fresh) {
        if (count >= limit) {
            rehash((mask + 1) * 2);
            if (oom) return nullptr;
        }
        size_t i = key_hash(k) & mask;
        while (t[i].key != EMPTY) {
            if (t[i].key == k) {
                *fresh = false;
                return &t[i].val;
            }
            i = (i + 1) & mask;
        }
        t[i].key = k;
        t[i].val = 0;
        count++;
        *fresh = true;
        return &t[i].val;
    }
};

// SET_TO_ASCII with bit order A=1, C=2, T=4, G=8 (2-bit code = bit index;
// encoding.py: b"-ACMTWYHGRSVKDBN")
static const char SET_ASCII[17] = "-ACMTWYHGRSVKDBN";

struct Result {
    int W = 1;
    long long n_rows = 0;
    int n_samples = 0;
    std::vector<uint64_t> keys;     // n_rows * W limbs (hi, lo)
    std::vector<uint8_t> variants;  // n_rows * n_samples ASCII
    std::vector<int64_t> counts;    // n_rows
};

static Result* g_result = nullptr;

// Rolling scan of one flat record-batch (0x00 separators); emits
// (canonical split key, 4-bit set) per window via cb. O(1) registers per
// base: incremental forward AND reverse-complement whole-window state
// (split_kmer.rs:159-217), split keys derived by dropping the middle
// 2-bit group.
template <class K, class F>
static void scan(const uint8_t* seq, long long L, int k, bool rc_on, F&& cb) {
    const int h = (k - 1) / 2;
    const K one = 1;
    const K kmask = (2 * k >= (int)sizeof(K) * 8)
                        ? (K)~(K)0
                        : ((one << (unsigned)(2 * k)) - 1);
    const K lowmask = (one << (unsigned)(2 * h)) - 1;
    K fwd = 0, rcw = 0;
    long long have = 0;
    for (long long i = 0; i < L; i++) {
        uint8_t c = seq[i];
        if (c == 0 || (c & 0xF) == 14) {  // separator / N: reset
            have = 0;
            fwd = 0;
            rcw = 0;
            continue;
        }
        K code = (K)((c >> 1) & 3);
        fwd = ((fwd << 2) | code) & kmask;
        rcw = (rcw >> 2) | ((code ^ (K)2) << (unsigned)(2 * (k - 1)));
        if (++have < k) continue;
        // build-vs-roll rule: a freshly built window (have == k) is only
        // emitted when it is NOT the record's final window
        if (have == k) {
            bool rec_last = (i + 1 == L) || seq[i + 1] == 0;
            if (rec_last) continue;
        }
        K fkey = ((fwd >> (unsigned)(2 * (h + 1))) << (unsigned)(2 * h)) |
                 (fwd & lowmask);
        uint8_t fmid = (uint8_t)((fwd >> (unsigned)(2 * h)) & 3);
        const long long start = i - k + 1;  // window start in the flat batch
        if (rc_on) {
            K rkey = ((rcw >> (unsigned)(2 * (h + 1))) << (unsigned)(2 * h)) |
                     (rcw & lowmask);
            if (rkey < fkey) {
                cb(rkey, (uint8_t)(1u << (fmid ^ 2)), start, true);
            } else if (rkey == fkey) {  // palindrome: W/S set
                cb(fkey, (uint8_t)((1u << fmid) | (1u << (fmid ^ 2))), start,
                   false);
            } else {
                cb(fkey, (uint8_t)(1u << fmid), start, false);
            }
        } else {
            cb(fkey, (uint8_t)(1u << fmid), start, false);
        }
    }
}

// FASTQ variant of scan(): per-base PHRED+33 quality gates
// (split_kmer.rs:66-71,99-100,156-157 via the python pipeline's exact
// semantics, ops/pipeline.py sample_pipeline):
//   * qual_ok = (q - 33) > min_qual STRICTLY, or q == 0xFF (a record
//     with no quality in a mixed batch always passes)
//   * strict (qf_mode 2): a failing base INVALIDATES the window like an
//     N; middle (1) and strict additionally gate EMISSION on the middle
//     base's quality; nofilter (0) ignores quality entirely
// cb receives (split_key, set, whole_canonical_key) — the whole-k-mer
// key feeds the per-sample min-count filter.
template <class K, class F>
static void scan_fastq(const uint8_t* seq, const uint8_t* qual, long long L,
                       int k, bool rc_on, int qf_mode, int min_qual,
                       F&& cb) {
    const int h = (k - 1) / 2;
    const K one = 1;
    const K kmask = (2 * k >= (int)sizeof(K) * 8)
                        ? (K)~(K)0
                        : ((one << (unsigned)(2 * k)) - 1);
    const K lowmask = (one << (unsigned)(2 * h)) - 1;
    const bool strict = qf_mode == 2;
    const bool midq = qf_mode >= 1;
    K fwd = 0, rcw = 0;
    long long have = 0;
    auto qok = [qual, min_qual](long long i) {
        uint8_t q = qual[i];
        return q == 0xFF || (int)q - 33 > min_qual;
    };
    for (long long i = 0; i < L; i++) {
        uint8_t c = seq[i];
        bool invalid = (c == 0) || ((c & 0xF) == 14) || (strict && !qok(i));
        if (invalid) {
            have = 0;
            fwd = 0;
            rcw = 0;
            continue;
        }
        K code = (K)((c >> 1) & 3);
        fwd = ((fwd << 2) | code) & kmask;
        rcw = (rcw >> 2) | ((code ^ (K)2) << (unsigned)(2 * (k - 1)));
        if (++have < k) continue;
        if (have == k) {
            bool rec_last = (i + 1 == L) || seq[i + 1] == 0;
            if (rec_last) continue;
        }
        const long long start = i - k + 1;
        if (midq && !qok(start + h)) continue;  // middle-base quality gate
        K fkey = ((fwd >> (unsigned)(2 * (h + 1))) << (unsigned)(2 * h)) |
                 (fwd & lowmask);
        uint8_t fmid = (uint8_t)((fwd >> (unsigned)(2 * h)) & 3);
        K whole = (rc_on && rcw < fwd) ? rcw : fwd;
        if (rc_on) {
            K rkey = ((rcw >> (unsigned)(2 * (h + 1))) << (unsigned)(2 * h)) |
                     (rcw & lowmask);
            if (rkey < fkey) {
                cb(rkey, (uint8_t)(1u << (fmid ^ 2)), whole);
            } else if (rkey == fkey) {
                cb(fkey, (uint8_t)((1u << fmid) | (1u << (fmid ^ 2))),
                   whole);
            } else {
                cb(fkey, (uint8_t)(1u << fmid), whole);
            }
        } else {
            cb(fkey, (uint8_t)(1u << fmid), whole);
        }
    }
}

// smallest power-of-two table that keeps n entries under 0.75 load
static size_t presize_for(long long n) {
    size_t want = 1 << 12;
    while ((size_t)n + (size_t)n / 3 >= want - want / 4 &&
           want < ((size_t)1 << 31))
        want <<= 1;
    return want;
}

// `ska cov` counting phase (coverage.rs:104-135,156-174 via
// ska_tpu/coverage.py): per-split-key occurrence counts of one flat
// record batch (quality ignored), histogrammed as out[c-1] = number of
// distinct keys seen exactly c times (c <= max_count; larger counts
// dropped). Returns distinct-key total, or <0 on error.
template <class K>
static long long cov_hist_impl(const uint8_t* seq, long long L, int k,
                               bool rc, long long max_count,
                               int64_t* out) {
    Map<K> counts(presize_for(L));
    if (counts.oom) return -2;
    bool oom = false;
    scan<K>(seq, L, k, rc, [&](K key, uint8_t, long long, bool) {
        if (oom) return;
        bool fresh;
        uint32_t* c = counts.slot(key, &fresh);
        if (!c) { oom = true; return; }
        ++*c;
    });
    if (oom || counts.oom) return -2;
    for (long long i = 0; i < max_count; i++) out[i] = 0;
    const size_t cap = counts.mask + 1;
    long long n_unique = 0;
    for (size_t i = 0; i < cap; i++) {
        if (counts.t[i].key == Map<K>::EMPTY) continue;
        n_unique++;
        uint32_t c = counts.t[i].val;
        if ((long long)c <= max_count) out[c - 1]++;
    }
    return n_unique;
}


template <class K>
static long long build_impl(int n_samples, const uint8_t** seqs,
                            const long long* lens, int k, bool rc, int W,
                            const uint8_t** quals = nullptr,
                            const uint8_t* is_reads = nullptr,
                            int qf_mode = 0, int min_qual = 20,
                            uint32_t min_count = 1) {
    // presize from the genome length: distinct split k-mers are bounded
    // by the window count, and growing a multi-MB map through doublings
    // costs more random re-inserts than the original insert stream
    long long maxlen = 0;
    for (int s = 0; s < n_samples; s++)
        if (lens[s] > maxlen) maxlen = lens[s];
    Map<K> merged(presize_for(maxlen));
    if (merged.oom) return -2;
    std::vector<uint8_t> store;  // rows x n_samples, '-' filled
    const size_t S = (size_t)n_samples;

    for (int s = 0; s < n_samples; s++) {
        // per-sample dict: key -> 4-bit set union (ska_dict.rs:76-113).
        // Inserts lag a 16-deep ring behind the rolling scan, with the
        // primary slot prefetched at enqueue time: the map outgrows the
        // caches within one bacterial genome, so an unpipelined insert
        // stream runs at memory latency per window.
        Map<K> dict(presize_for(lens[s]));
        if (dict.oom) return -2;
        bool oom = false;
        constexpr unsigned RD = 16;
        K rk[RD];
        uint8_t rs[RD];
        unsigned rh = 0, rcnt = 0;
        auto insert = [&](K key, uint8_t set) {
            bool fresh;
            uint32_t* v = dict.slot(key, &fresh);
            if (!v) { oom = true; return; }
            *v |= set;
        };
        auto enqueue = [&](K key, uint8_t set) {
            if (oom) return;
            if (rcnt == RD) {
                insert(rk[rh], rs[rh]);
                rh = (rh + 1) & (RD - 1);
                rcnt--;
            }
            __builtin_prefetch(dict.primary(key));
            unsigned tpos = (rh + rcnt) & (RD - 1);
            rk[tpos] = key;
            rs[tpos] = set;
            rcnt++;
        };
        const bool sample_reads =
            quals && quals[s] && is_reads && is_reads[s];
        if (sample_reads) {
            // FASTQ sample: quality gates + the per-sample whole-k-mer
            // min-count filter (ops/pipeline.py sample_pipeline: every
            // occurrence of one whole k-mer yields the SAME (split, set)
            // pair, so inserting exactly the min_count-th occurrence
            // reproduces the rank filter's dictionary bit for bit)
            Map<K> wcount(min_count > 1 ? presize_for(lens[s]) : (1 << 12));
            if (wcount.oom) return -2;
            scan_fastq<K>(seqs[s], quals[s], lens[s], k, rc, qf_mode,
                          min_qual, [&](K key, uint8_t set, K whole) {
                if (oom) return;
                if (min_count > 1) {
                    bool fresh;
                    uint32_t* c = wcount.slot(whole, &fresh);
                    if (!c) { oom = true; return; }
                    if (++*c != min_count) return;
                }
                enqueue(key, set);
            });
        } else {
            scan<K>(seqs[s], lens[s], k, rc,
                    [&](K key, uint8_t set, long long, bool) {
                enqueue(key, set);
            });
        }
        for (; rcnt && !oom; rcnt--, rh = (rh + 1) & (RD - 1))
            insert(rk[rh], rs[rh]);
        if (oom || dict.oom) return -2;
        // append into the merged map (merge_ska_dict.rs:77-109), again
        // with the merged primary slot prefetched a fixed lookahead out
        // (the dict walk itself is sequential and cheap)
        const size_t cap_slots = dict.mask + 1;
        size_t ahead = 0;
        unsigned pending = 0;
        for (size_t i = 0; i < cap_slots && dict.count; i++) {
            while (pending < RD && ahead < cap_slots) {
                if (dict.t[ahead].key != Map<K>::EMPTY) {
                    __builtin_prefetch(merged.primary(dict.t[ahead].key));
                    pending++;
                }
                ahead++;
            }
            if (dict.t[i].key == Map<K>::EMPTY) continue;
            pending--;
            bool fresh;
            uint32_t* rowp = merged.slot(dict.t[i].key, &fresh);
            if (!rowp) return -2;
            if (fresh) {
                *rowp = (uint32_t)(store.size() / S);
                try {
                    store.resize(store.size() + S, '-');
                } catch (const std::bad_alloc&) {
                    return -2;
                }
            }
            store[(size_t)(*rowp) * S + s] =
                (uint8_t)SET_ASCII[dict.t[i].val & 15];
        }
        if (merged.oom) return -2;
    }

    const long long R = (long long)(store.size() / (S ? S : 1));
    // global order: sort rows by key ascending (the device merge's order)
    std::vector<std::pair<K, uint32_t>> order;
    try {
        order.reserve(R);
    } catch (const std::bad_alloc&) {
        return -2;
    }
    for (size_t i = 0; i <= merged.mask && merged.count; i++)
        if (merged.t[i].key != Map<K>::EMPTY)
            order.emplace_back(merged.t[i].key, merged.t[i].val);
    std::sort(order.begin(), order.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });

    Result* res = new (std::nothrow) Result();
    if (!res) return -2;
    res->W = W;
    res->n_rows = R;
    res->n_samples = n_samples;
    try {
        res->keys.resize((size_t)R * W);
        res->variants.resize((size_t)R * S);
        res->counts.resize(R);
    } catch (const std::bad_alloc&) {
        delete res;
        return -2;
    }
    for (long long r = 0; r < R; r++) {
        K key = order[r].first;
        if (W == 1) {
            res->keys[r] = (uint64_t)key;
        } else {
            res->keys[2 * r] = (uint64_t)((u128)key >> 64);
            res->keys[2 * r + 1] = (uint64_t)key;
        }
        const uint8_t* src = store.data() + (size_t)order[r].second * S;
        uint8_t* dst = res->variants.data() + (size_t)r * S;
        memcpy(dst, src, S);
        int64_t cnt = 0;
        for (size_t j = 0; j < S; j++) cnt += dst[j] != '-';
        res->counts[r] = cnt;
    }
    delete g_result;
    g_result = res;
    return R;
}

struct RefScan {
    int W = 1;
    std::vector<uint64_t> keys;     // n * W limbs (hi, lo)
    std::vector<int64_t> pos;       // window start index in the flat batch
    std::vector<uint8_t> rcflag;    // 1 = reverse-strand canonical hit
};

static RefScan* g_refscan = nullptr;

template <class K>
static long long ref_scan_impl(const uint8_t* seq, long long L, int k,
                               bool rc, int W) {
    RefScan* rs = new (std::nothrow) RefScan();
    if (!rs) return -2;
    rs->W = W;
    try {
        rs->keys.reserve((size_t)L * W);
        rs->pos.reserve(L);
        rs->rcflag.reserve(L);
        scan<K>(seq, L, k, rc,
                [&](K key, uint8_t, long long start, bool is_rc) {
            if (W == 1) {
                rs->keys.push_back((uint64_t)key);
            } else {
                rs->keys.push_back((uint64_t)((u128)key >> 64));
                rs->keys.push_back((uint64_t)key);
            }
            rs->pos.push_back(start);
            rs->rcflag.push_back(is_rc ? 1 : 0);
        });
    } catch (const std::bad_alloc&) {
        delete rs;
        return -2;
    }
    delete g_refscan;
    g_refscan = rs;
    return (long long)rs->pos.size();
}

}  // namespace

extern "C" {

// Positional split k-mer scan of one flat record batch (the RefSka
// indexing pass, ska_ref.rs:189-311): emits every window's canonical
// key, its start index in the flat batch, and the strand flag, in
// positional order. Same emission semantics as the build scan.
long long ska_host_ref_scan(const uint8_t* seq, long long L, int k, int rc) {
    if (k < 5 || k > 63 || (k & 1) == 0) return -1;
    if (k <= 31) return ref_scan_impl<uint64_t>(seq, L, k, rc != 0, 1);
    return ref_scan_impl<u128>(seq, L, k, rc != 0, 2);
}
void ska_host_ref_scan_keys(uint64_t* out) {
    if (g_refscan)
        memcpy(out, g_refscan->keys.data(),
               g_refscan->keys.size() * sizeof(uint64_t));
}
void ska_host_ref_scan_pos(int64_t* out) {
    if (g_refscan)
        memcpy(out, g_refscan->pos.data(),
               g_refscan->pos.size() * sizeof(int64_t));
}
void ska_host_ref_scan_rc(uint8_t* out) {
    if (g_refscan)
        memcpy(out, g_refscan->rcflag.data(), g_refscan->rcflag.size());
}
void ska_host_ref_scan_release() {
    delete g_refscan;
    g_refscan = nullptr;
}

// zero-copy views of the retained scan (host_modes.cpp's all-native map
// engine reads them in place and releases when done — the memcpy
// accessors above cost ~55 ms at a 4 Mb reference's 4M windows)
const uint64_t* ska_host_ref_scan_keys_ptr() {
    return g_refscan ? g_refscan->keys.data() : nullptr;
}
const int64_t* ska_host_ref_scan_pos_ptr() {
    return g_refscan ? g_refscan->pos.data() : nullptr;
}
const uint8_t* ska_host_ref_scan_rc_ptr() {
    return g_refscan ? g_refscan->rcflag.data() : nullptr;
}

// Build + merge a FASTA cohort natively. seqs[i]/lens[i]: sample i's flat
// record batch (0x00 separators). Returns n_rows, or -2 on allocation
// failure. Results are retained until the next call / release; copy out
// with the accessors below.
long long ska_host_cov_hist(const uint8_t* seq, long long L,
                                       int k, int rc, long long max_count,
                                       int64_t* out) {
    if (k < 5 || k > 63 || (k & 1) == 0 || max_count < 1) return -1;
    try {
        if (k <= 31)
            return cov_hist_impl<uint64_t>(seq, L, k, rc != 0, max_count, out);
        return cov_hist_impl<u128>(seq, L, k, rc != 0, max_count, out);
    } catch (...) {
        return -3;
    }
}

long long ska_host_build(int n_samples, const uint8_t** seqs,
                         const long long* lens, int k, int rc) {
    if (n_samples <= 0 || k < 5 || k > 63 || (k & 1) == 0) return -1;
    if (k <= 31) return build_impl<uint64_t>(n_samples, seqs, lens, k, rc != 0, 1);
    return build_impl<u128>(n_samples, seqs, lens, k, rc != 0, 2);
}

// FASTQ-capable build: quals[s] = PHRED+33 bytes aligned with seqs[s]
// (0xFF = no-quality record positions), or NULL for a FASTA sample;
// is_reads[s] selects the quality/count machinery per sample. qf_mode:
// 0 nofilter, 1 middle, 2 strict (constants.py QUAL_FILTER order).
long long ska_host_build_fastq(int n_samples, const uint8_t** seqs,
                               const long long* lens,
                               const uint8_t** quals,
                               const uint8_t* is_reads, int k, int rc,
                               int qf_mode, int min_qual,
                               unsigned min_count) {
    if (n_samples <= 0 || k < 5 || k > 63 || (k & 1) == 0) return -1;
    if (qf_mode < 0 || qf_mode > 2) return -1;
    if (k <= 31)
        return build_impl<uint64_t>(n_samples, seqs, lens, k, rc != 0, 1,
                                    quals, is_reads, qf_mode, min_qual,
                                    min_count);
    return build_impl<u128>(n_samples, seqs, lens, k, rc != 0, 2, quals,
                            is_reads, qf_mode, min_qual, min_count);
}

void ska_host_build_keys(uint64_t* out) {
    if (g_result)
        memcpy(out, g_result->keys.data(),
               g_result->keys.size() * sizeof(uint64_t));
}
void ska_host_build_variants(uint8_t* out) {
    if (g_result)
        memcpy(out, g_result->variants.data(), g_result->variants.size());
}
void ska_host_build_counts(int64_t* out) {
    if (g_result)
        memcpy(out, g_result->counts.data(),
               g_result->counts.size() * sizeof(int64_t));
}
void ska_host_build_release() {
    delete g_result;
    g_result = nullptr;
}

// zero-copy views of the retained result (host_modes.cpp's all-native
// build command chains build -> save without the accessor memcpys)
const uint64_t* ska_host_build_keys_ptr() {
    return g_result ? g_result->keys.data() : nullptr;
}
const uint8_t* ska_host_build_variants_ptr() {
    return g_result ? g_result->variants.data() : nullptr;
}
const int64_t* ska_host_build_counts_ptr() {
    return g_result ? g_result->counts.data() : nullptr;
}

}  // extern "C"

extern "C" {

// Vectorized dict lookup for `ska map` host mode: binary search of m
// needle keys (each W uint64 limbs, W in {1,2}) in a lexicographically
// sorted (n x W) key table — one pass replaces numpy's
// searchsorted + clip + gather + row-compare chain (ska_ref.rs:508-533
// semantics: out_idx[i] = matching row, out_found[i] = 1 on exact hit).
// SKA_THREADS splits the needle range; disjoint output rows, race-free.
void ska_map_lookup(const uint64_t* sorted, long long n,
                    const uint64_t* needles, long long m, int W,
                    long long* out_idx, uint8_t* out_found) {
    if (W != 1 && W != 2) return;
    int T = 1;
    if (const char* t = getenv("SKA_THREADS")) {
        int v = atoi(t);
        if (v > 1) T = v > 64 ? 64 : v;
    }
    auto worker = [=](long long lo_i, long long hi_i) {
        if (W == 1) {
            for (long long i = lo_i; i < hi_i; ++i) {
                uint64_t q = needles[i];
                long long lo = 0, hi = n;
                while (lo < hi) {
                    long long mid = (lo + hi) >> 1;
                    if (sorted[mid] < q) lo = mid + 1; else hi = mid;
                }
                out_idx[i] = lo < n ? lo : (n ? n - 1 : 0);
                out_found[i] = (lo < n && sorted[lo] == q) ? 1 : 0;
            }
        } else {
            for (long long i = lo_i; i < hi_i; ++i) {
                uint64_t qh = needles[2 * i], ql = needles[2 * i + 1];
                long long lo = 0, hi = n;
                while (lo < hi) {
                    long long mid = (lo + hi) >> 1;
                    uint64_t sh = sorted[2 * mid], sl = sorted[2 * mid + 1];
                    if (sh < qh || (sh == qh && sl < ql)) lo = mid + 1;
                    else hi = mid;
                }
                out_idx[i] = lo < n ? lo : (n ? n - 1 : 0);
                out_found[i] = (lo < n && sorted[2 * lo] == qh &&
                                sorted[2 * lo + 1] == ql) ? 1 : 0;
            }
        }
    };
    if (T <= 1 || m < (1 << 16)) { worker(0, m); return; }
    std::vector<std::thread> ths;
    long long step = (m + T - 1) / T;
    for (int t = 0; t < T; ++t) {
        long long a = t * step, b = a + step < m ? a + step : m;
        if (a >= b) break;
        ths.emplace_back(worker, a, b);
    }
    for (auto& th : ths) th.join();
}

// Fused `ska map` lookup + row gather for host mode. Per ref k-mer, a
// PREFIX-BUCKETED binary search in the lex-sorted key table
// (ska_ref.rs:508-533): the top 16 bits of limb 0 index a 65536-entry
// start-offset table built in one linear pass, so each query descends
// ~log2(n/65536) steps inside one ~half-KB region instead of ~log2(n)
// cache-missing probes across the whole table. Hits then gather their
// variants row (through the optional sort permutation) with
// reverse-strand hits translated through RC_IUPAC in the same pass
// (ska_ref.rs:520-526) — replacing numpy's searchsorted + clip +
// row-compare + three hit-width temporaries (fancy-index gather,
// RC_IUPAC table gather, where-select), each of which costs fresh-page
// faults, which are slow on hosts with little memory bandwidth.
//
// Returns the hit count h; out_hit[0..h) = needle index of each hit
// (ascending), out_rows[0..h*S) = translated rows. Caller sizes both
// for m. perm may be NULL (variants already in sorted-key order).
// Requires n < 2^31 (rows fit int32 scratch); callers fall back to
// ska_map_lookup beyond that. SKA_THREADS splits the needle range;
// per-thread hit counts are prefix-summed so the packed outputs stay
// in needle order (byte-identical at any T).
long long ska_map_gather(const uint64_t* sorted, long long n,
                         const uint64_t* needles, long long m, int W,
                         const uint8_t* krc, const int64_t* perm,
                         const uint8_t* variants, int S,
                         const uint8_t* rc_tab,
                         int64_t* out_hit, uint8_t* out_rows) {
    if ((W != 1 && W != 2) || n < 0 || n > 0x7fffffffLL) return -1;
    int T = 1;
    if (const char* t = getenv("SKA_THREADS")) {
        int v = atoi(t);
        if (v > 1) T = v > 64 ? 64 : v;
    }
    if (m < (1 << 16)) T = 1;

    // bucket starts over the top 16 bits of limb 0 (lex order implies
    // limb-0 order, so buckets are contiguous in the sorted table)
    // 2^20 buckets (int32 starts, 4 MB): ~n/1M keys per bucket, so a
    // lane's whole probe range is 1-2 cache lines; the bucket-table
    // entries themselves are prefetched one batch ahead (needles are
    // read sequentially, so the next batch's buckets are known)
    constexpr int BB = 20;
    std::vector<int32_t> bstart;
    try {
        bstart.assign((1 << BB) + 2, 0);
    } catch (const std::bad_alloc&) {
        return -1;
    }
    for (long long i = 0; i < n; ++i)
        ++bstart[(sorted[(size_t)i * W] >> (64 - BB)) + 1];
    for (int b = 0; b < (1 << BB) + 1; ++b) bstart[b + 1] += bstart[b];

    const bool mg_tim = getenv("SKA_MG_TIME") != nullptr;
    auto mg_t0 = std::chrono::steady_clock::now();
    auto mg_lap = [&](const char* what) {
        if (!mg_tim) return;
        auto t1 = std::chrono::steady_clock::now();
        fprintf(stderr, "SKA_MG_TIME %s %.3fs\n", what,
                std::chrono::duration<double>(t1 - mg_t0).count());
        mg_t0 = t1;
    };
    mg_lap("buckets");
    std::vector<int32_t> row;  // per-needle matched row, -1 = miss
    try {
        row.resize((size_t)m);
    } catch (const std::bad_alloc&) {
        return -1;
    }
    int32_t* rowp = row.data();

    // Lane-interleaved search: each query's probe sequence is a serial
    // chain of cache misses into a ~60 MB table, so one query at a time
    // runs at memory latency (~200 ns/query measured). 16 searches
    // advance together, prefetching every lane's next midpoint before
    // any lane reads its current one — the misses overlap and the
    // per-query cost drops toward latency/16.
    // Lane-interleaved search: each query's probe sequence is a serial
    // chain of cache misses, so one query at a time runs at memory
    // latency (~200 ns/query measured). 32 searches advance together —
    // every round issues each live lane's next-midpoint prefetch before
    // any lane reads its current one, and the next BATCH's bucket-table
    // entries (4 MB table, misses L2) are prefetched a full batch
    // ahead — so the misses overlap and the per-query cost drops ~3x.
    auto search = [=](long long lo_i, long long hi_i) {
        constexpr int B = 32;
        long long lo[B], hi[B];
        uint64_t qh[B], ql[B];
        for (long long i = lo_i; i < hi_i; i += B) {
            int nb = (int)(hi_i - i < B ? hi_i - i : B);
            long long nx = i + B;
            int nn = (int)(hi_i - nx < B ? (hi_i > nx ? hi_i - nx : 0) : B);
            for (int l = 0; l < nn; ++l)
                __builtin_prefetch(
                    &bstart[needles[(size_t)W * (nx + l)] >> (64 - BB)]);
            for (int l = 0; l < nb; ++l) {
                qh[l] = needles[(size_t)W * (i + l)];
                if (W == 2) ql[l] = needles[2 * (i + l) + 1];
                unsigned b = (unsigned)(qh[l] >> (64 - BB));
                lo[l] = bstart[b];
                hi[l] = bstart[b + 1];
                if (lo[l] < hi[l]) {
                    // a bucket is 1-2 lines at ~4 keys; cover its range
                    const uint8_t* base =
                        (const uint8_t*)&sorted[(size_t)W * lo[l]];
                    const uint8_t* end =
                        (const uint8_t*)&sorted[(size_t)W * hi[l]];
                    __builtin_prefetch(base);
                    __builtin_prefetch(base + ((end - base) >> 1));
                    __builtin_prefetch(end - 1);
                }
            }
            for (bool active = true; active;) {
                active = false;
                for (int l = 0; l < nb; ++l) {
                    if (lo[l] >= hi[l]) continue;
                    long long mid = (lo[l] + hi[l]) >> 1;
                    if (W == 1) {
                        if (sorted[mid] < qh[l]) lo[l] = mid + 1;
                        else hi[l] = mid;
                    } else {
                        uint64_t sh = sorted[2 * mid], sl = sorted[2 * mid + 1];
                        if (sh < qh[l] || (sh == qh[l] && sl < ql[l]))
                            lo[l] = mid + 1;
                        else hi[l] = mid;
                    }
                    if (lo[l] < hi[l]) {
                        __builtin_prefetch(
                            &sorted[(size_t)W * ((lo[l] + hi[l]) >> 1)]);
                        active = true;
                    }
                }
            }
            for (int l = 0; l < nb; ++l) {
                unsigned b = (unsigned)(qh[l] >> (64 - BB));
                long long p = lo[l];
                bool found =
                    p < bstart[b + 1] && sorted[(size_t)W * p] == qh[l] &&
                    (W == 1 || sorted[2 * p + 1] == ql[l]);
                rowp[i + l] = found ? (int32_t)p : -1;
            }
        }
    };

    long long step = (m + T - 1) / T;
    if (T <= 1) {
        search(0, m);
    } else {
        std::vector<std::thread> ths;
        for (int t = 0; t < T; ++t) {
            long long a = t * step, b = a + step < m ? a + step : m;
            if (a >= b) break;
            ths.emplace_back(search, a, b);
        }
        for (auto& th : ths) th.join();
    }

    mg_lap("search");
    // pack hits in needle order: per-range hit counts -> output offsets
    std::vector<long long> off(T + 1, 0);
    for (int t = 0; t < T; ++t) {
        long long a = t * step, b = a + step < m ? a + step : m;
        long long c = 0;
        for (long long i = a; i < b && a < m; ++i) c += rowp[i] >= 0;
        off[t + 1] = off[t] + (a < m ? c : 0);
    }

    auto pack = [=](long long lo_i, long long hi_i, long long o) {
        for (long long i = lo_i; i < hi_i; ++i) {
            // two-stage lookahead: perm[] row 16 hits out, its variants
            // row 8 hits out (by then perm[rowp[i+8]] is cache-resident)
            if (i + 16 < hi_i && perm && rowp[i + 16] >= 0)
                __builtin_prefetch(&perm[rowp[i + 16]]);
            if (i + 8 < hi_i && rowp[i + 8] >= 0)
                __builtin_prefetch(
                    variants +
                    (size_t)(perm ? perm[rowp[i + 8]] : rowp[i + 8]) * S);
            int32_t r = rowp[i];
            if (r < 0) continue;
            out_hit[o] = i;
            long long vrow = perm ? perm[r] : (long long)r;
            const uint8_t* src = variants + (size_t)vrow * S;
            uint8_t* dst = out_rows + (size_t)o * S;
            if (krc[i])
                for (int s = 0; s < S; ++s) dst[s] = rc_tab[src[s]];
            else
                memcpy(dst, src, (size_t)S);
            ++o;
        }
    };
    if (T <= 1) {
        pack(0, m, 0);
    } else {
        std::vector<std::thread> ths;
        for (int t = 0; t < T; ++t) {
            long long a = t * step, b = a + step < m ? a + step : m;
            if (a >= b) break;
            ths.emplace_back(pack, a, b, off[t]);
        }
        for (auto& th : ths) th.join();
    }
    mg_lap("pack");
    return off[T];
}

// Single-pass site-filter predicates (merge_ska_array.rs:289-402 /
// ska_tpu/array.py SkaArray.filter): per row of the (n x S) ASCII
// variants matrix, out_keep[i] = (counts[i] >= min_count) && pred(mode).
// Replaces numpy's full-matrix int16 widening + where + min/max
// reduction chain (~140 MB of temporaries at 4.4M x 4, ~2.5 s on this
// host's fault weather) with one read of the matrix itself.
//
// modes: 0 = no-filter; 1 = no-const (>1 distinct value among the
// considered cells; considered = all cells, or non-'-' cells when
// ignore_const_gaps); 2 = no-ambig (no cell is IUPAC-ambiguous per the
// 256-entry is_ambig table); 3 = no-ambig-or-const (>1 of the presence
// classes {A,C,G,T,U} — plus '-' unless ignore_const_gaps — occur).
// counts is int64 (counts_is_i64) or uint8 (the byte-narrow .skf
// decode); is_ambig may be NULL for modes 0/1.
void ska_filter_keep(const uint8_t* v, long long n, int S,
                     const void* counts, int counts_is_i64,
                     long long min_count, int mode,
                     int ignore_const_gaps, const uint8_t* is_ambig,
                     uint8_t* out_keep) {
    const int64_t* c64 = counts_is_i64 ? (const int64_t*)counts : nullptr;
    const uint8_t* c8 = counts_is_i64 ? nullptr : (const uint8_t*)counts;
    for (long long i = 0; i < n; ++i) {
        long long cnt = c64 ? c64[i] : (long long)c8[i];
        bool keep = cnt >= min_count;
        if (keep && mode != 0) {
            const uint8_t* row = v + (size_t)i * S;
            if (mode == 1) {
                int first = -1;
                bool two = false;
                for (int s = 0; s < S; ++s) {
                    uint8_t b = row[s];
                    if (ignore_const_gaps && b == '-') continue;
                    if (first < 0) first = b;
                    else if (b != first) { two = true; break; }
                }
                keep = two;
            } else if (mode == 2) {
                bool amb = false;
                for (int s = 0; s < S; ++s) amb |= is_ambig[row[s]] != 0;
                keep = !amb;
            } else {  // mode 3
                unsigned classes = 0;
                for (int s = 0; s < S; ++s) {
                    switch (row[s]) {
                        case 'A': classes |= 1u; break;
                        case 'C': classes |= 2u; break;
                        case 'G': classes |= 4u; break;
                        case 'T': classes |= 8u; break;
                        case 'U': classes |= 16u; break;
                        case '-': if (!ignore_const_gaps) classes |= 32u;
                                  break;
                        default: break;
                    }
                }
                keep = __builtin_popcount(classes) > 1;
            }
        }
        out_keep[i] = keep ? 1 : 0;
    }
}

// Single-pass per-row non-missing recount (merge_ska_array.rs:139-163 /
// ska_tpu/array.py update_counts): cells != '-' (and not ambiguous when
// drop_ambig). One matrix read instead of numpy's bool matrix + mask +
// sum-reduce temporaries.
void ska_update_counts(const uint8_t* v, long long n, int S,
                       int drop_ambig, const uint8_t* is_ambig,
                       int64_t* out_counts) {
    for (long long i = 0; i < n; ++i) {
        const uint8_t* row = v + (size_t)i * S;
        long long c = 0;
        if (drop_ambig) {
            for (int s = 0; s < S; ++s)
                c += (row[s] != '-' && !is_ambig[row[s]]);
        } else {
            for (int s = 0; s < S; ++s) c += row[s] != '-';
        }
        out_counts[i] = c;
    }
}

}  // extern "C"
