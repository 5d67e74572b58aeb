// Landau-Vishkin CIGARs and MD/NM/XV tags for a batch of gapped reads,
// semantics-identical to the Python versions the tests hold it to:
//
//   * ops/lv.py:lv_cigar_host, itself computeEditDistanceWithCigar
//     (Align_src/LandauVishkin.c:296-351, backtrace :380-460; useM = 1,
//     compact CIGAR, no straight-mismatch shortcut): the 8-byte group run
//     match on one-hot bytes, the zero bytes read before the text, the
//     diagonal order 0, -1, 1, -2, 2 ..., the X / D / I preference on
//     ties, the run merging of the backtrace, (-1, "") past k;
//   * io/sam.py:md_nm_tag (sam_add_md_nm, sam.c:246-328) over the CIGAR
//     just produced: MD with '^' deletions, NM, XV capped at 64 offsets.
//
// A row whose Python version would index outside its arrays (a text cut
// short at the end of the index, k past the 64 bytes before the text), or
// whose strings outgrow the caller's slots, is handed back with e = -2:
// the caller runs the Python version on it, which does what it does
// there.  Nothing else differs, so no row's output depends on the path.
//
// Exposed via ctypes as salt_lv_cigar_batch().

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

const long LPAD = 64;            // ops/lv.py:_LPAD
const long TAIL_PAD = 64;        // np.pad(text, (_LPAD, 64)), pattern's too
const int MISSING = INT_MIN;     // an (e, d) cell the Python dict lacks
const uint8_t NT2BIT[5] = {1, 2, 4, 8, 15};
const char BASES[] = "ACGTN";

struct Fallback {};              // hand the row back to the Python version

// One row as lv_cigar_host pads it: tpad = LPAD zeros, the text, zeros;
// ppad = the one-hot pattern, zeros.  Slices past either end read as
// zeros (np.pad of a short group); a direct index past them raises there.
struct Row {
    const uint8_t* text;
    long tl;
    const uint8_t* pat;
    long pl;

    uint8_t t(long j) const {    // tpad[j] for j >= 0, zero past the end
        j -= LPAD;
        return (j >= 0 && j < tl) ? text[j] : 0;
    }
    uint8_t p(long i) const { return (i >= 0 && i < pl) ? pat[i] : 0; }
    uint8_t t_at(long j) const { // tpad[j] as a direct index
        if (j < 0 || j >= LPAD + tl + TAIL_PAD) throw Fallback();
        return t(j);
    }
    uint8_t p_at(long i) const {
        if (i < 0 || i >= pl + TAIL_PAD) throw Fallback();
        return p(i);
    }
};

// _run_match(ppad, tpad[LPAD + d:], start, endl)
long run_match(const Row& r, long d, long start, long endl) {
    if (LPAD + d < 0) throw Fallback();   // a negative slice start
    long i = start;
    for (;;) {
        uint8_t gp[8], gt[8];
        bool equal = true;
        for (int z = 0; z < 8; ++z) {
            gp[z] = r.p(i + z);
            gt[z] = r.t(LPAD + d + i + z);
            equal = equal && gp[z] == gt[z];
        }
        if (!equal) {
            int z = 0;
            while (z < 8 && (gp[z] & gt[z])) ++z;
            if (z < 8) return std::min(i + z, endl);
            i += 8;
            continue;
        }
        i += 8;
        if (i >= endl) return endl;
    }
}

void put(std::string& out, long count, char code) {
    if (count > 0) {
        out += std::to_string(count);
        out += code;
    }
}

// lv_cigar_host(text, pattern, k): returns e (-1 past k) and the CIGAR.
long lv_cigar(const Row& r, long k, std::string& cigar) {
    long pl = r.pl, tl = r.tl;
    long endl = std::min(pl, tl);
    long l00 = run_match(r, 0, 0, endl);
    if (l00 == endl) {
        cigar = std::to_string(pl) + "M";
        return 0;
    }
    if (k < 1) return -1;
    long W = 2 * k + 1;          // diagonals -k..k of one row
    std::vector<long> Lv((k + 1) * W, MISSING);
    std::vector<char> Av((k + 1) * W, 0);
    auto at = [&](long e, long d) { return e * W + d + k; };
    auto get = [&](long e, long d) -> long {   // L.get((e, d), -2)
        if (d < -k || d > k) return -2;
        long v = Lv[at(e, d)];
        return v == MISSING ? -2 : v;
    };
    auto must = [&](long e, long d) -> long {  // L[(e, d)]
        if (d < -k || d > k || Lv[at(e, d)] == MISSING) throw Fallback();
        return Lv[at(e, d)];
    };
    Lv[at(0, 0)] = l00;
    for (long e = 1; e <= k; ++e) {
        long d = 0;
        while (d != -(e + 1)) {
            long best = get(e - 1, d) + 1;
            char act = 'X';
            long left = get(e - 1, d - 1);
            if (left > best) {
                best = left;
                act = 'D';
            }
            long right = get(e - 1, d + 1) + 1;
            if (right > best) {
                best = right;
                act = 'I';
            }
            Av[at(e, d)] = act;
            if (best >= 0 && r.p_at(best) == r.t_at(LPAD + d + best)) {
                long endl_d = std::min(pl, tl - d);
                best = run_match(r, d, best, endl_d);
            }
            Lv[at(e, d)] = best;
            if (best == pl) {
                // backtrace (LandauVishkin.c:380-460, useM path)
                std::vector<char> action(e + 1);
                std::vector<long> matched(e + 1);
                long cur_d = d;
                for (long ce = e; ce > 0; --ce) {
                    if (cur_d < -k || cur_d > k || !Av[at(ce, cur_d)])
                        throw Fallback();
                    char a = Av[at(ce, cur_d)];
                    action[ce] = a;
                    long nd = a == 'I' ? cur_d + 1 : a == 'D' ? cur_d - 1
                                                               : cur_d;
                    matched[ce] = must(ce, cur_d) - must(ce - 1, nd)
                                  - (a == 'D' ? 0 : 1);
                    cur_d = nd;
                }
                long acc = l00;
                long ce = 1;
                while (ce <= e) {
                    char a = action[ce];
                    long n = 1;
                    while (ce + 1 <= e && matched[ce] == 0
                           && action[ce + 1] == a) {
                        ++n;
                        ++ce;
                    }
                    if (a == 'X') {
                        acc += n;
                    } else {
                        if (acc != 0) {
                            put(cigar, acc, 'M');
                            acc = 0;
                        }
                        put(cigar, n, a);
                    }
                    if (matched[ce] > 0) acc += matched[ce];
                    ++ce;
                }
                if (acc != 0) put(cigar, acc, 'M');
                return e;
            }
            d = d >= 0 ? -(d + 1) : -d;
        }
    }
    return -1;
}

// md_nm_tag(index, pos, 0, s, _, cigar, 0) over the windows pac[pos:] and
// mixref[pos:] (n_pac and n_mix bytes of them are the index's) for the
// strand-selected read codes s[0:L].
void md_nm_tag(const std::string& cigar, const uint8_t* pac, long n_pac,
               const uint8_t* mix, long n_mix, const uint8_t* s, long L,
               std::string& tag) {
    if (cigar == std::to_string(L) + "M" && n_pac < L) {
        throw Fallback();        // the fast path's slices would not align
    }
    long nm = 0, n_match = 0, ref = 0, si = 0;
    std::string md;
    std::vector<long> rs;
    size_t c = 0;
    while (c < cigar.size()) {
        long n = 0;
        while (c < cigar.size() && cigar[c] >= '0' && cigar[c] <= '9')
            n = n * 10 + (cigar[c++] - '0');
        char op = cigar[c++];
        if (op == 'M') {
            for (long j = 0; j < n; ++j, ++ref, ++si) {
                if (ref >= n_pac || si >= L) throw Fallback();
                int bt = pac[ref];
                if (bt == s[si]) {
                    ++n_match;
                    continue;
                }
                if (ref >= n_mix) throw Fallback();
                if ((mix[ref] >> s[si]) & 1 && rs.size() < 64)
                    rs.push_back(si);
                ++nm;
                if (n_match != 0) md += std::to_string(n_match);
                n_match = 0;
                md += BASES[std::min(bt, 4)];
            }
        } else if (op == 'I') {
            nm += n;
            si += n;
        } else if (op == 'D') {
            if (n_match != 0) md += std::to_string(n_match);
            n_match = 0;
            nm += n;
            md += '^';
            for (long j = 0; j < n; ++j, ++ref) {
                if (ref >= n_pac) throw Fallback();
                md += BASES[std::min<int>(pac[ref], 4)];
            }
        }
    }
    if (n_match != 0) md += std::to_string(n_match);
    tag = "\tMD:Z:" + md + "\tNM:i:" + std::to_string(nm);
    if (!rs.empty()) {
        tag += "\tXV:i:";
        for (size_t j = 0; j < rs.size(); ++j) {
            if (j) tag += ',';
            tag += std::to_string(rs[j]);
        }
    }
}

bool store(const std::string& s, char* slot, int cap) {
    if ((long)s.size() >= cap) return false;
    std::memcpy(slot, s.data(), s.size());
    slot[s.size()] = 0;
    return true;
}

}  // namespace

extern "C" {

// n rows of read length L.  Row i: `codes` + i*L, its strand-selected read
// codes (0..4); `mix` + i*W and `pac` + i*W, the index's mixref and pac
// from the row's position, of which mix_len[i] and pac_len[i] bytes are
// the index's; text_len[i] <= mix_len[i] of mixref is the LV text; k[i]
// the band; want_tag[i] asks for the MD/NM/XV tag.  Writes e_out[i] (the
// edit distance, -1 past k, -2 handed back), and NUL-terminated strings
// into the row's cigar_cap bytes of `cigar` and tag_cap bytes of `tag`.
int salt_lv_cigar_batch(int n, int L, int W, const uint8_t* codes,
                        const uint8_t* mix, const int32_t* mix_len,
                        const int32_t* text_len, const uint8_t* pac,
                        const int32_t* pac_len, const int32_t* k,
                        const uint8_t* want_tag, int32_t* e_out,
                        char* cigar, int cigar_cap, char* tag, int tag_cap) {
    if (n < 0 || L < 0 || W < 0 || cigar_cap < 1 || tag_cap < 1) return 1;
    std::vector<uint8_t> pat(L);
    std::string cig, tg;
    for (int i = 0; i < n; ++i) {
        const uint8_t* s = codes + (long)i * L;
        const uint8_t* mi = mix + (long)i * W;
        char* cslot = cigar + (long)i * cigar_cap;
        char* tslot = tag + (long)i * tag_cap;
        cslot[0] = 0;
        tslot[0] = 0;
        for (int j = 0; j < L; ++j) pat[j] = NT2BIT[std::min<int>(s[j], 4)];
        cig.clear();
        tg.clear();
        long e;
        try {
            Row r{mi, text_len[i], pat.data(), L};
            e = lv_cigar(r, k[i], cig);
            if (want_tag[i])
                md_nm_tag(cig, pac + (long)i * W, pac_len[i], mi, mix_len[i],
                          s, L, tg);
            if (!store(cig, cslot, cigar_cap) || !store(tg, tslot, tag_cap))
                e = -2;
        } catch (const Fallback&) {
            e = -2;
        }
        e_out[i] = (int32_t)e;
    }
    return 0;
}

}  // extern "C"
