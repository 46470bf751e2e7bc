// ska_host: all-native launcher target for pinned-host commands.
//
// The `ska` launcher execs this binary (instead of CPython) for
// align / distance / map / build when SKA_PLATFORM=cpu, so the one-pass
// C++ engines (host_modes.cpp) run without the ~0.3 s CPython+ctypes
// startup — on this host that tax alone exceeded the whole single-core
// reference `ska align`. Anything this front-end does not understand —
// unknown or abbreviated flags, -v (progress messages live in the
// python pipeline), -h, FASTQ/gz inputs, a failing engine — falls back
// by exec()ing `$SKA_PYTHON ska.py` with the ORIGINAL argv, which
// reproduces the python route's behavior (and its exact error
// messages) from scratch.
//
// Grammar mirrored from ska_tpu/cli.py build_parser() for the supported
// subset; validators that would make argparse error out (bad ranges,
// bad choices) fall back so python prints the canonical message.
// Stderr banner/footer parity with cli.py _main/_footer.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <string>
#include <unistd.h>
#include <vector>

extern "C" {
long long ska_host_nk(const char* skf_path, int full);
long long ska_host_weed(const char* skf_path, const char* weed_fa,
                        int reverse, double min_freq, int mode,
                        int ambig_as_missing, int ambig_mask,
                        int ignore_const_gaps, const char* out_path);
long long ska_host_delete(const char* skf_path, const uint8_t* del_blob,
                          long long del_len, long long n_del,
                          const char* out_path);
long long ska_host_merge(const uint8_t* paths_blob, long long paths_len,
                         long long n_files, const char* out_path,
                         const uint8_t* version, long long version_len);
long long ska_host_align_fasta(const uint8_t* paths_blob,
                               long long paths_len,
                               const uint8_t* names_blob,
                               long long names_len, long long n_files,
                               const char* out_path, double min_freq,
                               int mode, int ambig_as_missing,
                               int ambig_mask, int ignore_const_gaps);
long long ska_host_map_fasta(const char* ref_path,
                             const uint8_t* paths_blob, long long paths_len,
                             const uint8_t* names_blob, long long names_len,
                             long long n_files, const char* out_path,
                             int vcf, int ambig_mask, int repeat_mask);
long long ska_host_align(const char* skf_path, const char* out_path,
                         double min_freq, int mode, int ambig_as_missing,
                         int ambig_mask, int ignore_const_gaps);
long long ska_host_distance(const char* skf_path, const char* out_path,
                            double min_freq, int filt_ambig);
long long ska_host_map(const char* ref_path, const char* skf_path,
                       const char* out_path, int vcf, int ambig_mask,
                       int repeat_mask);
long long ska_host_build_files(const char* out_path,
                               const uint8_t* paths_blob, long long paths_len,
                               long long n_files, const uint8_t* names_blob,
                               long long names_len, int k, int rc,
                               const uint8_t* version, long long version_len);
long long ska_host_build_files2(
    const char* out_path, const uint8_t* p1_blob, long long p1_len,
    const uint8_t* p2_blob, long long p2_len, long long n_files,
    const uint8_t* names_blob, long long names_len, int k, int rc,
    int qf_mode, int min_qual, long long min_count,
    const uint8_t* version, long long version_len);
}

// keep in sync with ska_tpu/__init__.py __version__ (the .skf
// ska_version field; tests/test_host_cli.py pins the byte-identity of
// launcher-built and python-built files, which catches drift here)
static const char* SKA_VERSION = "0.5.2";

namespace {

int g_argc;
char** g_argv;

[[noreturn]] void fallback() {
    // exec the python CLI with the original argv; SKA_PLATFORM=cpu is
    // already in the environment (the launcher set it before exec'ing us)
    std::string self(g_argv[0]);
    char buf[4096];
    ssize_t n = readlink("/proc/self/exe", buf, sizeof(buf) - 1);
    if (n > 0) {
        buf[n] = 0;
        self.assign(buf);
    }
    size_t slash = self.rfind('/');
    std::string dir = slash == std::string::npos ? "." : self.substr(0, slash);
    std::string ska_py = dir + "/ska.py";
    const char* py = getenv("SKA_PYTHON");
    if (!py || !*py) py = "python3";
    std::vector<char*> av;
    av.push_back((char*)py);
    av.push_back((char*)ska_py.c_str());
    for (int i = 1; i < g_argc; i++) av.push_back(g_argv[i]);
    av.push_back(nullptr);
    execvp(py, av.data());
    perror("ska_host: exec python fallback");
    exit(127);
}

struct Args {
    std::vector<std::string> pos;
    // flag name (exact long/short form) -> value; presence map for bools
    std::vector<std::pair<std::string, std::string>> opts;
};

// tiny argv scanner: exact flag names only; takes_value tells whether
// the NEXT argv (or =rest / attached short rest) is consumed. Unknown
// flags fall back to python.
struct Spec {
    const char* name;
    bool takes_value;
};

bool parse(int argc, char** argv, const std::vector<Spec>& specs, Args& out) {
    for (int i = 0; i < argc; i++) {
        std::string a(argv[i]);
        if (a.empty()) return false;
        if (a[0] != '-' || a == "-") {  // "-" is a positional (stdout path)
            out.pos.push_back(a);
            continue;
        }
        std::string name = a, val;
        bool has_val = false;
        size_t eq = a.find('=');
        if (a.size() > 2 && a[1] == '-' && eq != std::string::npos) {
            name = a.substr(0, eq);
            val = a.substr(eq + 1);
            has_val = true;
        } else if (a.size() > 2 && a[1] != '-') {
            // attached short value (-oout.aln)
            name = a.substr(0, 2);
            val = a.substr(2);
            has_val = true;
        }
        const Spec* sp = nullptr;
        for (auto& s : specs)
            if (name == s.name) { sp = &s; break; }
        if (!sp) return false;  // unknown/abbreviated flag: python route
        if (sp->takes_value) {
            if (!has_val) {
                if (i + 1 >= argc) return false;
                val = argv[++i];
                // argparse refuses a flag-like token as an option value
                // ("expected one argument"); bare "-" (stdout) is fine
                if (val.size() > 1 && val[0] == '-') return false;
            }
        } else if (has_val) {
            return false;  // e.g. --ambig-mask=1 is not argparse grammar
        }
        out.opts.emplace_back(sp->name, val);
    }
    return true;
}

const std::string* get(const Args& a, const char* n1, const char* n2 = nullptr) {
    const std::string* r = nullptr;
    for (auto& kv : a.opts)
        if (kv.first == n1 || (n2 && kv.first == n2)) r = &kv.second;
    return r;  // last occurrence wins, like argparse
}

bool parse_float01(const std::string& s, double& out) {
    char* end = nullptr;
    out = strtod(s.c_str(), &end);
    return end && *end == 0 && out >= 0.0 && out <= 1.0;
}

bool parse_threads(const std::string& s, long& out) {
    char* end = nullptr;
    out = strtol(s.c_str(), &end, 10);
    return end && *end == 0 && out >= 1;
}

bool first_byte_is(const std::string& path, char c) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return false;
    int b = fgetc(f);
    fclose(f);
    return b == c;
}

void banner() {
    fprintf(stderr, "SKA: Split K-mer Analysis (the alignment-free aligner)\n");
}

[[noreturn]] void footer_exit(time_t start) {
    fprintf(stderr, "SKA done in %llds\n", (long long)(time(nullptr) - start));
    fprintf(stderr, "\xE2\xAC\x9B\xE2\xAC\x9C\xE2\xAC\x9B\xE2\xAC\x9C\xE2\xAC\x9B\xE2\xAC\x9C\xE2\xAC\x9B\n");
    fprintf(stderr, "\xE2\xAC\x9C\xE2\xAC\x9B\xE2\xAC\x9C\xE2\xAC\x9B\xE2\xAC\x9C\xE2\xAC\x9B\xE2\xAC\x9C\n");
    exit(0);
}

void set_threads(const Args& a) {
    const std::string* t = get(a, "--threads");
    if (t) {
        long v;
        if (!parse_threads(*t, v)) fallback();
        setenv("SKA_THREADS", t->c_str(), 1);
    }
}

// extension-stripped sample naming (host_cmds.py _RE_PATH/_RE_NAME;
// reference io_utils.rs:31-46): basename minus .fa/.fasta/.fastq[.gz],
// case-insensitive; no recognized extension keeps the full path
std::string sample_name(const std::string& p) {
    auto ieq = [](const std::string& s, size_t at, const char* suf) {
        size_t n = strlen(suf);
        if (at + n != s.size()) return false;
        for (size_t i = 0; i < n; i++)
            if (tolower((unsigned char)s[at + i]) != suf[i]) return false;
        return true;
    };
    size_t slash = p.rfind('/');
    std::string base = slash == std::string::npos ? p : p.substr(slash + 1);
    size_t dot = base.rfind('.');
    for (const char* suf : {".fa", ".fasta", ".fastq"}) {
        if (dot != std::string::npos && ieq(base, dot, suf))
            return base.substr(0, dot);
    }
    // .fastq.gz: two extensions
    if (base.size() > 9) {
        size_t gz = base.size() - 3;
        if (ieq(base, gz, ".gz")) {
            std::string stem = base.substr(0, gz);
            size_t d2 = stem.rfind('.');
            if (d2 != std::string::npos && ieq(stem, d2, ".fastq"))
                return stem.substr(0, d2);
        }
    }
    return p;  // _RE_NAME failed: python keeps the whole given path
}

// NUL-separated (paths, names) blobs for an all-plain-FASTA positional
// list of >= 2 files (implicit build); false to fall back
bool fasta_blobs(const std::vector<std::string>& pos, size_t from,
                 std::string& paths, std::string& names) {
    if (pos.size() - from < 2) return false;
    for (size_t i = from; i < pos.size(); i++) {
        if (!first_byte_is(pos[i], '>')) return false;
        if (i > from) {
            paths.push_back('\0');
            names.push_back('\0');
        }
        paths += pos[i];
        names += sample_name(pos[i]);
    }
    return true;
}

}  // namespace

int main(int argc, char** argv) {
    g_argc = argc;
    g_argv = argv;
    if (argc < 2) fallback();
    if (getenv("SKA_COORDINATOR")) fallback();  // multi-process: python path
    const char* nc = getenv("SKA_NATIVE_CMDS");
    if (nc && !strcmp(nc, "0")) fallback();
    std::string cmd(argv[1]);
    time_t start = time(nullptr);

    if (cmd == "align") {
        Args a;
        if (!parse(argc - 2, argv + 2,
                   {{"-o", true},
                    {"-m", true},
                    {"--min-freq", true},
                    {"--filter-ambig-as-missing", false},
                    {"--filter", true},
                    {"--ambig-mask", false},
                    {"--no-gap-only-sites", false},
                    {"--threads", true}},
                   a))
            fallback();
        if (a.pos.empty()) fallback();
        bool implicit = a.pos.size() > 1;
        std::string bpaths, bnames;
        if (implicit) {
            // implicit build from a plain-FASTA list (io_utils.rs:60-93)
            if (!fasta_blobs(a.pos, 0, bpaths, bnames)) fallback();
        } else if (first_byte_is(a.pos[0], '>')) {
            fallback();  // single FASTA: python raises the .skf error
        }
        double mf = 0.9;
        if (const std::string* v = get(a, "-m", "--min-freq"))
            if (!parse_float01(*v, mf)) fallback();
        int mode = 1;  // no-const default
        if (const std::string* v = get(a, "--filter")) {
            if (*v == "no-filter") mode = 0;
            else if (*v == "no-const") mode = 1;
            else if (*v == "no-ambig") mode = 2;
            else if (*v == "no-ambig-or-const") mode = 3;
            else fallback();
        }
        set_threads(a);
        const std::string* o = get(a, "-o");
        banner();
        long long rc_a;
        if (implicit) {
            rc_a = ska_host_align_fasta(
                (const uint8_t*)bpaths.data(), (long long)bpaths.size(),
                (const uint8_t*)bnames.data(), (long long)bnames.size(),
                (long long)a.pos.size(), o ? o->c_str() : "-", mf, mode,
                get(a, "--filter-ambig-as-missing") != nullptr,
                get(a, "--ambig-mask") != nullptr,
                get(a, "--no-gap-only-sites") != nullptr);
        } else {
            rc_a = ska_host_align(
                a.pos[0].c_str(), o ? o->c_str() : "-", mf, mode,
                get(a, "--filter-ambig-as-missing") != nullptr,
                get(a, "--ambig-mask") != nullptr,
                get(a, "--no-gap-only-sites") != nullptr);
        }
        if (rc_a != 0) fallback();
        footer_exit(start);
    }

    if (cmd == "nk") {
        Args a;
        if (!parse(argc - 2, argv + 2, {{"--full-info", false}}, a))
            fallback();
        if (a.pos.size() != 1) fallback();
        banner();
        if (ska_host_nk(a.pos[0].c_str(),
                        get(a, "--full-info") != nullptr) != 0)
            fallback();
        footer_exit(start);
    }

    if (cmd == "distance") {
        Args a;
        if (!parse(argc - 2, argv + 2,
                   {{"-o", true},
                    {"-m", true},
                    {"--min-freq", true},
                    {"--allow-ambiguous", false},
                    {"--threads", true}},
                   a))
            fallback();
        if (a.pos.size() != 1) fallback();
        double mf = 0.0;
        if (const std::string* v = get(a, "-m", "--min-freq"))
            if (!parse_float01(*v, mf)) fallback();
        set_threads(a);
        const std::string* o = get(a, "-o");
        banner();
        if (ska_host_distance(a.pos[0].c_str(), o ? o->c_str() : "-", mf,
                              get(a, "--allow-ambiguous") == nullptr) != 0)
            fallback();
        footer_exit(start);
    }

    if (cmd == "map") {
        Args a;
        if (!parse(argc - 2, argv + 2,
                   {{"-o", true},
                    {"-f", true},
                    {"--format", true},
                    {"--ambig-mask", false},
                    {"--repeat-mask", false},
                    {"--threads", true}},
                   a))
            fallback();
        if (a.pos.size() < 2) fallback();  // reference + input(s)
        bool implicit = a.pos.size() > 2;
        std::string bpaths, bnames;
        if (implicit) {
            if (!fasta_blobs(a.pos, 1, bpaths, bnames)) fallback();
        } else if (first_byte_is(a.pos[1], '>')) {
            fallback();  // single FASTA input: python raises
        }
        int vcf = 0;
        if (const std::string* v = get(a, "-f", "--format")) {
            if (*v == "vcf") vcf = 1;
            else if (*v == "aln") vcf = 0;
            else fallback();
        }
        set_threads(a);
        const std::string* o = get(a, "-o");
        banner();
        long long rc_m;
        if (implicit) {
            rc_m = ska_host_map_fasta(
                a.pos[0].c_str(), (const uint8_t*)bpaths.data(),
                (long long)bpaths.size(), (const uint8_t*)bnames.data(),
                (long long)bnames.size(), (long long)(a.pos.size() - 1),
                o ? o->c_str() : "-", vcf,
                get(a, "--ambig-mask") != nullptr,
                get(a, "--repeat-mask") != nullptr);
        } else {
            rc_m = ska_host_map(a.pos[0].c_str(), a.pos[1].c_str(),
                                o ? o->c_str() : "-", vcf,
                                get(a, "--ambig-mask") != nullptr,
                                get(a, "--repeat-mask") != nullptr);
        }
        if (rc_m != 0) fallback();
        footer_exit(start);
    }

    if (cmd == "merge") {
        Args a;
        if (!parse(argc - 2, argv + 2, {{"-o", true}}, a)) fallback();
        const std::string* o = get(a, "-o");
        if (!o || a.pos.size() < 2) fallback();  // python prints the errors
        std::string blob;
        for (size_t i = 0; i < a.pos.size(); i++) {
            if (i) blob.push_back('\0');
            blob += a.pos[i];
        }
        std::string out = *o;
        if (out.size() < 4 || out.compare(out.size() - 4, 4, ".skf") != 0)
            out += ".skf";
        banner();
        if (ska_host_merge((const uint8_t*)blob.data(),
                           (long long)blob.size(), (long long)a.pos.size(),
                           out.c_str(), (const uint8_t*)SKA_VERSION,
                           (long long)strlen(SKA_VERSION)) != 0)
            fallback();
        footer_exit(start);
    }

    if (cmd == "weed") {
        Args a;
        if (!parse(argc - 2, argv + 2,
                   {{"-o", true},
                    {"--reverse", false},
                    {"-m", true},
                    {"--min-freq", true},
                    {"--filter-ambig-as-missing", false},
                    {"--filter", true},
                    {"--ambig-mask", false},
                    {"--no-gap-only-sites", false}},
                   a))
            fallback();
        if (a.pos.size() < 1 || a.pos.size() > 2) fallback();
        double mf = 0.9;  // DEFAULT_MINFREQ (cli.py weed -m default)
        if (const std::string* v = get(a, "-m", "--min-freq"))
            if (!parse_float01(*v, mf)) fallback();
        int mode = 0;  // weed --filter default: no-filter
        if (const std::string* v = get(a, "--filter")) {
            if (*v == "no-filter") mode = 0;
            else if (*v == "no-const") mode = 1;
            else if (*v == "no-ambig") mode = 2;
            else if (*v == "no-ambig-or-const") mode = 3;
            else fallback();
        }
        const std::string* o = get(a, "-o");
        // weed saves to the EXACT path (generic_modes.rs:263-266)
        std::string out = o ? *o : a.pos[0];
        banner();
        if (ska_host_weed(a.pos[0].c_str(),
                          a.pos.size() == 2 ? a.pos[1].c_str() : nullptr,
                          get(a, "--reverse") != nullptr, mf, mode,
                          get(a, "--filter-ambig-as-missing") != nullptr,
                          get(a, "--ambig-mask") != nullptr,
                          get(a, "--no-gap-only-sites") != nullptr,
                          out.c_str()) != 0)
            fallback();
        footer_exit(start);
    }

    if (cmd == "delete") {
        Args a;
        if (!parse(argc - 2, argv + 2,
                   {{"-s", true},
                    {"--skf-file", true},
                    {"-o", true},
                    {"-f", true}},
                   a))
            fallback();
        const std::string* skf = get(a, "-s", "--skf-file");
        if (!skf) fallback();  // argparse: required
        std::vector<std::string> names;
        if (const std::string* fl = get(a, "-f")) {
            if (!a.pos.empty()) fallback();
            FILE* f = fopen(fl->c_str(), "rb");
            if (!f) fallback();
            std::string line;
            int c;
            bool ok = true;
            auto flush_line = [&]() {
                size_t i = 0;
                std::vector<std::string> fields;
                while (i < line.size()) {
                    while (i < line.size() && isspace((unsigned char)line[i])) i++;
                    size_t b = i;
                    while (i < line.size() && !isspace((unsigned char)line[i])) i++;
                    if (i > b) fields.push_back(line.substr(b, i - b));
                }
                if (fields.empty()) return;
                if (fields.size() != 2) { ok = false; return; }
                names.push_back(fields[0]);
            };
            while ((c = fgetc(f)) != EOF) {
                if (c == '\n') { flush_line(); line.clear(); }
                else line.push_back((char)c);
            }
            flush_line();
            fclose(f);
            if (!ok) fallback();
        } else {
            // positional names pass through the extension-stripping
            // regexes (cli dispatch -> fastx.get_input_list)
            for (auto& p : a.pos) names.push_back(sample_name(p));
        }
        if (names.empty()) fallback();
        std::string blob;
        for (size_t i = 0; i < names.size(); i++) {
            if (i) blob.push_back('\0');
            blob += names[i];
        }
        const std::string* o = get(a, "-o");
        std::string out = o ? *o : *skf;
        // delete saves via skf.save add_suffix=True
        if (out.size() < 4 || out.compare(out.size() - 4, 4, ".skf") != 0)
            out += ".skf";
        banner();
        if (ska_host_delete(skf->c_str(), (const uint8_t*)blob.data(),
                            (long long)blob.size(),
                            (long long)names.size(), out.c_str()) != 0)
            fallback();
        footer_exit(start);
    }

    if (cmd == "build") {
        const char* nb = getenv("SKA_NATIVE_BUILD");
        if (nb && !strcmp(nb, "0")) fallback();
        Args a;
        // --min-count/--min-qual/--qual-filter are FASTQ-only concerns:
        // accepted and unused on a plain-FASTA cohort, exactly like the
        // python native-build route (host_cmds.py try_run)
        if (!parse(argc - 2, argv + 2,
                   {{"-f", true},
                    {"-o", true},
                    {"-k", true},
                    {"--proportion-reads", true},
                    {"--single-strand", false},
                    {"--min-count", true},
                    {"--min-qual", true},
                    {"--qual-filter", true},
                    {"--threads", true}},
                   a))
            fallback();
        if (get(a, "--proportion-reads")) fallback();  // read subsampling
        const std::string* o = get(a, "-o");
        if (!o) fallback();  // argparse: required, errors out
        long k = 31;
        if (const std::string* v = get(a, "-k")) {
            char* end = nullptr;
            k = strtol(v->c_str(), &end, 10);
            if (!end || *end != 0 || k < 5 || k > 63 || (k % 2) == 0)
                fallback();  // python prints the canonical validator error
        }
        set_threads(a);
        // quality/count flags (FASTA cohorts ignore them, exactly like
        // the python native-build route)
        long long mc = 5;  // DEFAULT_MINCOUNT
        if (const std::string* v = get(a, "--min-count")) {
            char* end = nullptr;
            mc = strtoll(v->c_str(), &end, 10);
            // "auto" fits the coverage model: python pipeline
            if (!end || *end != 0 || mc < 1) fallback();
        }
        long mq = 20;  // DEFAULT_MINQUAL
        if (const std::string* v = get(a, "--min-qual")) {
            char* end = nullptr;
            mq = strtol(v->c_str(), &end, 10);
            if (!end || *end != 0) fallback();
        }
        int qf = 2;  // strict default
        if (const std::string* v = get(a, "--qual-filter")) {
            if (*v == "no-filter") qf = 0;
            else if (*v == "middle") qf = 1;
            else if (*v == "strict") qf = 2;
            else fallback();
        }
        // input list: positionals (single files), or a 2/3-column file
        // list (3 columns = FASTQ pair, io_utils.rs:116-146)
        struct In {
            std::string name, f1, f2;
        };
        std::vector<In> inputs;
        if (const std::string* fl = get(a, "-f")) {
            if (!a.pos.empty()) fallback();  // ambiguous: python decides
            FILE* f = fopen(fl->c_str(), "rb");
            if (!f) fallback();
            std::string line;
            int c;
            auto flush_line = [&]() -> bool {
                if (line.empty()) return true;
                std::vector<std::string> fields;
                size_t i = 0;
                while (i < line.size()) {
                    while (i < line.size() && isspace((unsigned char)line[i])) i++;
                    size_t b = i;
                    while (i < line.size() && !isspace((unsigned char)line[i])) i++;
                    if (i > b) fields.push_back(line.substr(b, i - b));
                }
                if (fields.empty()) return true;
                if (fields.size() == 2)
                    inputs.push_back({fields[0], fields[1], ""});
                else if (fields.size() == 3)
                    inputs.push_back({fields[0], fields[1], fields[2]});
                else
                    return false;
                return true;
            };
            bool ok = true;
            while ((c = fgetc(f)) != EOF) {
                if (c == '\n') {
                    if (!flush_line()) { ok = false; break; }
                    line.clear();
                } else {
                    line.push_back((char)c);
                }
            }
            if (ok) ok = flush_line();
            fclose(f);
            if (!ok) fallback();
        } else {
            for (auto& p : a.pos) inputs.push_back({sample_name(p), p, ""});
        }
        if (inputs.empty()) fallback();
        bool all_fasta = true;
        for (auto& in : inputs)
            all_fasta &= in.f2.empty() && first_byte_is(in.f1, '>');
        std::string out_path = *o;
        if (out_path.size() < 4 ||
            out_path.compare(out_path.size() - 4, 4, ".skf") != 0)
            out_path += ".skf";
        std::string p1, p2, names;
        for (size_t i = 0; i < inputs.size(); i++) {
            if (i) {
                p1.push_back('\0');
                p2.push_back('\0');
                names.push_back('\0');
            }
            names += inputs[i].name;
            p1 += inputs[i].f1;
            p2 += inputs[i].f2;
        }
        banner();
        long long rc_b;
        if (all_fasta) {
            rc_b = ska_host_build_files(
                out_path.c_str(), (const uint8_t*)p1.data(),
                (long long)p1.size(), (long long)inputs.size(),
                (const uint8_t*)names.data(), (long long)names.size(),
                (int)k, get(a, "--single-strand") == nullptr,
                (const uint8_t*)SKA_VERSION,
                (long long)strlen(SKA_VERSION));
        } else {
            rc_b = ska_host_build_files2(
                out_path.c_str(), (const uint8_t*)p1.data(),
                (long long)p1.size(), (const uint8_t*)p2.data(),
                (long long)p2.size(), (long long)inputs.size(),
                (const uint8_t*)names.data(), (long long)names.size(),
                (int)k, get(a, "--single-strand") == nullptr, qf,
                (int)mq, mc, (const uint8_t*)SKA_VERSION,
                (long long)strlen(SKA_VERSION));
        }
        if (rc_b != 0) fallback();
        footer_exit(start);
    }

    fallback();  // unknown subcommand (incl. -v/--verbose/-h leading)
}
