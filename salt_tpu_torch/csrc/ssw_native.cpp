// Native striped Smith-Waterman, semantics-identical to the Python
// emulation in salt_tpu_torch/ops/ssw.py (itself bit-faithful to the published
// SSW 0.1.4 algorithm: byte pass with bias/saturation, word rerun on
// overflow, lazy-F correction, reverse pass for begin positions, banded
// traceback for the cigar).  Scalar C++ over the 16/8 SIMD lanes — the
// lane arrays are tiny, the win over the numpy lane emulation is ~10^3.
//
// Exposed via ctypes as salt_ssw_align().

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct Best {
    int score;
    int ref;   // end_ref
    int read;  // end_read
};

static inline uint8_t adds_u8(uint8_t a, uint8_t b) {
    int s = int(a) + int(b);
    return uint8_t(s > 255 ? 255 : s);
}
static inline uint8_t subs_u8(uint8_t a, uint8_t b) {
    int s = int(a) - int(b);
    return uint8_t(s < 0 ? 0 : s);
}
static inline int16_t subs_u16(int16_t a, int16_t b) {
    int s = int(a) - int(b);
    return int16_t(s < 0 ? 0 : s);
}

// query profile, byte flavor: prof[c][j*16+lane]
static std::vector<uint8_t> qp_byte(const int8_t* read, int readLen,
                                    const int8_t* mat, int n, int bias) {
    int segLen = (readLen + 15) / 16;
    std::vector<uint8_t> prof(size_t(n) * segLen * 16, uint8_t(bias));
    for (int c = 0; c < n; ++c)
        for (int j = 0; j < segLen; ++j)
            for (int lane = 0; lane < 16; ++lane) {
                int r = j + lane * segLen;
                if (r < readLen)
                    prof[(size_t(c) * segLen + j) * 16 + lane] =
                        uint8_t(int(mat[c * n + read[r]]) + bias);
            }
    return prof;
}

static std::vector<int16_t> qp_word(const int8_t* read, int readLen,
                                    const int8_t* mat, int n) {
    int segLen = (readLen + 7) / 8;
    std::vector<int16_t> prof(size_t(n) * segLen * 8, 0);
    for (int c = 0; c < n; ++c)
        for (int j = 0; j < segLen; ++j)
            for (int lane = 0; lane < 8; ++lane) {
                int r = j + lane * segLen;
                if (r < readLen)
                    prof[(size_t(c) * segLen + j) * 8 + lane] =
                        mat[c * n + read[r]];
            }
    return prof;
}

// lane left-shift by one (SSE _mm_slli_si128 on the lane view)
template <typename T, int W>
static inline void slli(T* v) {
    for (int i = W - 1; i > 0; --i) v[i] = v[i - 1];
    v[0] = 0;
}

static void sw_byte(const int8_t* ref, int ref_dir, int refLen, int readLen,
                    int gapO, int gapE, const uint8_t* prof, int segLen,
                    int terminate, int bias, int maskLen,
                    Best* best, Best* second) {
    std::vector<uint8_t> maxColumn(refLen, 0);
    std::vector<uint8_t> HStore(size_t(segLen) * 16, 0),
        HLoad(size_t(segLen) * 16, 0), E(size_t(segLen) * 16, 0),
        Hmax(size_t(segLen) * 16, 0);
    int maxv = 0, end_read = readLen - 1, end_ref = -1;
    uint8_t vMaxScore[16] = {0}, vMaxMark[16] = {0};

    for (int step = 0; step < refLen; ++step) {
        int i = ref_dir == 0 ? step : refLen - 1 - step;
        uint8_t vF[16] = {0}, vMaxColumn[16] = {0}, vH[16];
        std::memcpy(vH, &HStore[size_t(segLen - 1) * 16], 16);
        slli<uint8_t, 16>(vH);
        const uint8_t* vP = prof + size_t(uint8_t(ref[i])) * segLen * 16;
        HLoad.swap(HStore);
        for (int j = 0; j < segLen; ++j) {
            uint8_t* e = &E[size_t(j) * 16];
            uint8_t* hs = &HStore[size_t(j) * 16];
            const uint8_t* hl = &HLoad[size_t(j) * 16];
            for (int l = 0; l < 16; ++l) {
                uint8_t h = subs_u8(adds_u8(vH[l], vP[j * 16 + l]), uint8_t(bias));
                h = std::max(h, e[l]);
                h = std::max(h, vF[l]);
                vMaxColumn[l] = std::max(vMaxColumn[l], h);
                hs[l] = h;
                uint8_t h2 = subs_u8(h, uint8_t(gapO));
                uint8_t en = subs_u8(e[l], uint8_t(gapE));
                e[l] = std::max(en, h2);
                vF[l] = std::max(subs_u8(vF[l], uint8_t(gapE)), h2);
                vH[l] = hl[l];
            }
        }
        // lazy-F
        {
            int j = 0;
            uint8_t vHl[16];
            std::memcpy(vHl, &HStore[0], 16);
            slli<uint8_t, 16>(vF);
            for (;;) {
                bool any = false;
                for (int l = 0; l < 16; ++l)
                    if (subs_u8(vF[l], subs_u8(vHl[l], uint8_t(gapO))) != 0) {
                        any = true;
                        break;
                    }
                if (!any) break;
                for (int l = 0; l < 16; ++l) {
                    uint8_t h = std::max(vHl[l], vF[l]);
                    vMaxColumn[l] = std::max(vMaxColumn[l], h);
                    HStore[size_t(j) * 16 + l] = h;
                    vF[l] = subs_u8(vF[l], uint8_t(gapE));
                }
                ++j;
                if (j >= segLen) {
                    j = 0;
                    slli<uint8_t, 16>(vF);
                }
                std::memcpy(vHl, &HStore[size_t(j) * 16], 16);
            }
        }
        bool changed = false;
        for (int l = 0; l < 16; ++l) {
            vMaxScore[l] = std::max(vMaxScore[l], vMaxColumn[l]);
            if (vMaxScore[l] != vMaxMark[l]) changed = true;
        }
        if (changed) {
            std::memcpy(vMaxMark, vMaxScore, 16);
            int temp = 0;
            for (int l = 0; l < 16; ++l) temp = std::max(temp, int(vMaxScore[l]));
            if (temp > maxv) {
                maxv = temp;
                if (maxv + bias >= 255) break;
                end_ref = i;
                Hmax = HStore;
            }
        }
        uint8_t mc = 0;
        for (int l = 0; l < 16; ++l) mc = std::max(mc, vMaxColumn[l]);
        maxColumn[i] = mc;
        if (int(mc) == terminate) break;
    }

    for (int fi = 0; fi < segLen * 16; ++fi)
        if (int(Hmax[fi]) == maxv) {
            int j = fi / 16, lane = fi % 16;
            int temp = j + lane * segLen;
            if (temp < end_read) end_read = temp;
        }
    best->score = (maxv + bias >= 255) ? 255 : maxv;
    best->ref = end_ref;
    best->read = end_read;

    int s2 = 0, r2 = 0;
    int edge = std::max(end_ref - maskLen, 0);
    for (int i = 0; i < edge; ++i)
        if (int(maxColumn[i]) > s2) { s2 = maxColumn[i]; r2 = i; }
    edge = (end_ref + maskLen > refLen) ? refLen : end_ref + maskLen;
    for (int i = edge + 1; i < refLen; ++i)
        if (int(maxColumn[i]) > s2) { s2 = maxColumn[i]; r2 = i; }
    second->score = s2;
    second->ref = r2;
    second->read = 0;
}

static void sw_word(const int8_t* ref, int ref_dir, int refLen, int readLen,
                    int gapO, int gapE, const int16_t* prof, int segLen,
                    int terminate, int maskLen, Best* best, Best* second) {
    std::vector<uint16_t> maxColumn(refLen, 0);
    std::vector<int16_t> HStore(size_t(segLen) * 8, 0),
        HLoad(size_t(segLen) * 8, 0), E(size_t(segLen) * 8, 0),
        Hmax(size_t(segLen) * 8, 0);
    int maxv = 0, end_read = readLen - 1, end_ref = 0;
    int16_t vMaxScore[8] = {0}, vMaxMark[8] = {0};

    for (int step = 0; step < refLen; ++step) {
        int i = ref_dir == 0 ? step : refLen - 1 - step;
        int16_t vF[8] = {0}, vMaxColumn[8] = {0}, vH[8];
        std::memcpy(vH, &HStore[size_t(segLen - 1) * 8], 8 * sizeof(int16_t));
        slli<int16_t, 8>(vH);
        const int16_t* vP = prof + size_t(uint8_t(ref[i])) * segLen * 8;
        HLoad.swap(HStore);
        for (int j = 0; j < segLen; ++j) {
            int16_t* e = &E[size_t(j) * 8];
            int16_t* hs = &HStore[size_t(j) * 8];
            const int16_t* hl = &HLoad[size_t(j) * 8];
            for (int l = 0; l < 8; ++l) {
                int hv = int(vH[l]) + int(vP[j * 8 + l]);
                hv = std::min(std::max(hv, -32768), 32767);
                int16_t h = int16_t(hv);
                h = std::max(h, e[l]);
                h = std::max(h, vF[l]);
                vMaxColumn[l] = std::max(vMaxColumn[l], h);
                hs[l] = h;
                int16_t h2 = subs_u16(h, int16_t(gapO));
                int16_t en = subs_u16(e[l], int16_t(gapE));
                e[l] = std::max(en, h2);
                vF[l] = std::max(subs_u16(vF[l], int16_t(gapE)), h2);
                vH[l] = hl[l];
            }
        }
        // lazy-F (word flavor)
        {
            bool done = false;
            for (int k = 0; k < 8 && !done; ++k) {
                slli<int16_t, 8>(vF);
                for (int j = 0; j < segLen; ++j) {
                    int16_t* hs = &HStore[size_t(j) * 8];
                    int16_t h2v[8];
                    for (int l = 0; l < 8; ++l) {
                        int16_t h = std::max(hs[l], vF[l]);
                        hs[l] = h;
                        h2v[l] = subs_u16(h, int16_t(gapO));
                        vF[l] = subs_u16(vF[l], int16_t(gapE));
                    }
                    bool any = false;
                    for (int l = 0; l < 8; ++l)
                        if (vF[l] > h2v[l]) { any = true; break; }
                    if (!any) { done = true; break; }
                }
            }
        }
        bool changed = false;
        for (int l = 0; l < 8; ++l) {
            vMaxScore[l] = std::max(vMaxScore[l], vMaxColumn[l]);
            if (vMaxScore[l] != vMaxMark[l]) changed = true;
        }
        if (changed) {
            std::memcpy(vMaxMark, vMaxScore, sizeof vMaxMark);
            int temp = 0;
            for (int l = 0; l < 8; ++l) temp = std::max(temp, int(vMaxScore[l]));
            if (temp > maxv) {
                maxv = temp;
                end_ref = i;
                Hmax = HStore;
            }
        }
        int mc = 0;
        for (int l = 0; l < 8; ++l) mc = std::max(mc, int(vMaxColumn[l]));
        maxColumn[i] = uint16_t(std::max(mc, 0));
        if (mc == terminate) break;
    }

    for (int fi = 0; fi < segLen * 8; ++fi)
        if (int(Hmax[fi]) == maxv) {
            int j = fi / 8, lane = fi % 8;
            int temp = j + lane * segLen;
            if (temp < end_read) end_read = temp;
        }
    best->score = maxv;
    best->ref = end_ref;
    best->read = end_read;

    int s2 = 0, r2 = 0;
    int edge = std::max(end_ref - maskLen, 0);
    for (int i = 0; i < edge; ++i)
        if (int(maxColumn[i]) > s2) { s2 = maxColumn[i]; r2 = i; }
    edge = (end_ref + maskLen > refLen) ? refLen : end_ref + maskLen;
    for (int i = edge; i < refLen; ++i)
        if (int(maxColumn[i]) > s2) { s2 = maxColumn[i]; r2 = i; }
    second->score = s2;
    second->ref = r2;
    second->read = 0;
}

// banded traceback; ops are written as (count << 2) | op, op in {0:M,1:I,2:D}
static int banded_sw(const int8_t* ref, const int8_t* read, int refLen,
                     int readLen, int score, int gapO, int gapE,
                     int band_width, const int8_t* mat, int n,
                     uint32_t* ops_out, int ops_cap) {
    auto set_u = [](int w, int i, int j) {
        int x = i - w;
        if (x < 0) x = 0;
        return j - x + 1;
    };
    std::vector<int64_t> h_b, e_b, h_c;
    std::vector<int8_t> direction;
    for (;;) {
        int width = band_width * 2 + 3;
        int width_d = band_width * 2 + 1;
        h_b.assign(width + 2, 0);
        e_b.assign(width + 2, 0);
        h_c.assign(width + 2, 0);
        direction.assign(size_t(readLen) * width_d * 3, 0);
        int64_t maxv = 0;
        for (int i = 0; i < readLen; ++i) {
            int beg = std::max(0, i - band_width);
            int end = std::min(refLen - 1, i + band_width);
            int edge = std::min(end + 1, width - 1);
            int64_t f = 0;
            h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0;
            int u = 0;
            int8_t* dir = &direction[size_t(i) * width_d * 3];
            for (int j = beg; j <= end; ++j) {
                u = set_u(band_width, i, j);
                int eu = set_u(band_width, i - 1, j);
                int b = set_u(band_width, i, j - 1);
                int d = set_u(band_width, i - 1, j - 1);
                int x = std::max(i - band_width, 0);
                int de = (j - x) * 3 + 0, df = (j - x) * 3 + 1, dh = (j - x) * 3 + 2;
                int64_t t1 = i == 0 ? -gapO : h_b[eu] - gapO;
                int64_t t2 = i == 0 ? -gapE : e_b[eu] - gapE;
                e_b[u] = std::max(t1, t2);
                dir[de] = t1 > t2 ? 3 : 2;
                t1 = h_c[b] - gapO;
                t2 = f - gapE;
                f = std::max(t1, t2);
                dir[df] = t1 > t2 ? 5 : 4;
                int64_t e1 = std::max(e_b[u], int64_t(0));
                int64_t f1 = std::max(f, int64_t(0));
                t1 = std::max(e1, f1);
                t2 = h_b[d] + mat[uint8_t(ref[j]) * n + uint8_t(read[i])];
                h_c[u] = std::max(t1, t2);
                if (h_c[u] > maxv) maxv = h_c[u];
                if (t1 <= t2) dir[dh] = 1;
                else dir[dh] = e1 > f1 ? dir[de] : dir[df];
            }
            for (int k = 1; k <= u; ++k) h_b[k] = h_c[k];
        }
        if (maxv >= score) break;
        band_width *= 2;
    }
    int width_d = band_width * 2 + 1;
    // traceback
    int i = readLen - 1, j = refLen - 1, e = 0, fcur = 0, maxop = 0, temp2 = 2;
    std::vector<uint32_t> rev;
    while (i > 0) {
        int x = std::max(i - band_width, 0);
        int8_t d = direction[(size_t(i) * width_d + (j - x)) * 3 + temp2];
        switch (d) {
            case 1: --i; --j; temp2 = 2; fcur = 0; break;
            case 2: --i; temp2 = 0; fcur = 1; break;
            case 3: --i; temp2 = 2; fcur = 1; break;
            case 4: --j; temp2 = 1; fcur = 2; break;
            case 5: --j; temp2 = 2; fcur = 2; break;
            default: return -1;  // traceback error
        }
        if (fcur == maxop) ++e;
        else {
            rev.push_back(uint32_t(e) << 2 | uint32_t(maxop));
            maxop = fcur;
            e = 1;
        }
    }
    if (maxop == 0) rev.push_back(uint32_t(e + 1) << 2);
    else {
        rev.push_back(uint32_t(e) << 2 | uint32_t(maxop));
        rev.push_back(uint32_t(1) << 2);
    }
    int m = int(rev.size());
    if (m > ops_cap) return -2;
    for (int k = 0; k < m; ++k) ops_out[k] = rev[size_t(m - 1 - k)];
    return m;
}

}  // namespace

extern "C" {

// result layout: [score1, score2, ref_begin1, ref_end1, read_begin1,
//                 read_end1, ref_end2, n_cigar]
int salt_ssw_align(const int8_t* read, int readLen, const int8_t* ref,
                   int refLen, const int8_t* mat, int n, int gapO, int gapE,
                   int maskLen, int want_cigar, int32_t* out,
                   uint32_t* cigar_out, int cigar_cap) {
    int bias = 0;
    for (int k = 0; k < n * n; ++k) bias = std::min(bias, int(mat[k]));
    bias = bias < 0 ? -bias : 0;
    // a read code outside 0..n-1 (an N on the reverse strand is 3 - 4,
    // int8 -1 or byte 255) scores as the last code, the N column, as the
    // numpy version's index -1 does: never a read outside the matrix
    std::vector<int8_t> codes(read, read + readLen);
    for (auto& c : codes)
        if (uint8_t(c) >= n) c = int8_t(n - 1);
    read = codes.data();

    Best best, second;
    bool word = false;
    {
        auto prof = qp_byte(read, readLen, mat, n, bias);
        int segLen = (readLen + 15) / 16;
        sw_byte(ref, 0, refLen, readLen, gapO, gapE, prof.data(), segLen,
                0xFF, bias, maskLen, &best, &second);
    }
    if (best.score == 255) {
        auto prof = qp_word(read, readLen, mat, n);
        int segLen = (readLen + 7) / 8;
        sw_word(ref, 0, refLen, readLen, gapO, gapE, prof.data(), segLen,
                0xFFFF, maskLen, &best, &second);
        word = true;
    }
    int score1 = best.score, ref_end1 = best.ref, read_end1 = best.read;
    int score2 = second.score, ref_end2 = second.ref;
    if (maskLen < 15) { score2 = 0; ref_end2 = -1; }

    std::vector<int8_t> read_rev(read_end1 + 1);
    for (int k = 0; k <= read_end1; ++k) read_rev[k] = read[read_end1 - k];
    Best bestr, secr;
    if (!word) {
        auto prof = qp_byte(read_rev.data(), read_end1 + 1, mat, n, bias);
        int segLen = (read_end1 + 1 + 15) / 16;
        sw_byte(ref, 1, ref_end1 + 1, read_end1 + 1, gapO, gapE, prof.data(),
                segLen, score1, bias, maskLen, &bestr, &secr);
    } else {
        auto prof = qp_word(read_rev.data(), read_end1 + 1, mat, n);
        int segLen = (read_end1 + 1 + 7) / 8;
        sw_word(ref, 1, ref_end1 + 1, read_end1 + 1, gapO, gapE, prof.data(),
                segLen, score1, maskLen, &bestr, &secr);
    }
    int ref_begin1 = bestr.ref;
    int read_begin1 = read_end1 - bestr.read;

    int ncig = 0;
    if (want_cigar) {
        int rl = ref_end1 - ref_begin1 + 1;
        int ql = read_end1 - read_begin1 + 1;
        int bw = std::abs(rl - ql) + 1;
        ncig = banded_sw(ref + ref_begin1, read + read_begin1, rl, ql, score1,
                         gapO, gapE, bw, mat, n, cigar_out, cigar_cap);
    }
    out[0] = score1;
    out[1] = score2;
    out[2] = ref_begin1;
    out[3] = ref_end1;
    out[4] = read_begin1;
    out[5] = read_end1;
    out[6] = ref_end2;
    out[7] = ncig;
    return 0;
}

}  // extern "C"
