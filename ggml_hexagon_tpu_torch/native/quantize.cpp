// Native quantization kernels — C++17, multithreaded.
//
// The host-side analog of the reference's quantize path
// (ggml/src/ggml-quants.c reference encoders driven by
// src/llama-quant.cpp's thread fan-out): bit-identical semantics to
// quant/ref_numpy.py (which is the tested-against-gguf-py oracle), but
// ~20-50x faster for whole-model quantization.  Exposed through a C ABI
// consumed with ctypes (native/__init__.py); the NumPy implementation
// remains the differential oracle.
//
// The PyTorch port's own copy: ggml_hexagon_tpu_torch/native builds it
// with g++ at first use into ggml_hexagon_tpu_torch/_build/.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

typedef uint16_t half;

half f32_to_f16(float f) {
    // round-to-nearest-even float16 conversion (bit-exact with numpy)
    uint32_t x;
    std::memcpy(&x, &f, 4);
    uint32_t sign = (x >> 16) & 0x8000u;
    int32_t exp = (int32_t)((x >> 23) & 0xff) - 127 + 15;
    uint32_t mant = x & 0x7fffffu;
    if (((x >> 23) & 0xff) == 0xff) {  // inf/nan
        return (half)(sign | 0x7c00u | (mant ? 0x200u : 0u));
    }
    if (exp >= 0x1f) return (half)(sign | 0x7c00u);
    if (exp <= 0) {
        if (exp < -10) return (half)sign;
        mant |= 0x800000u;
        uint32_t shift = (uint32_t)(1 - exp);
        uint32_t rounded = (mant + ((1u << (12 + shift)) >> 1) + (((mant >> (13 + shift)) & 1) ? 0u : 0u)) >> (13 + shift);
        // round half to even
        uint32_t lsb_mask = (1u << (13 + shift)) - 1;
        uint32_t rem = mant & lsb_mask;
        uint32_t half_pt = 1u << (12 + shift);
        uint32_t base = mant >> (13 + shift);
        if (rem > half_pt || (rem == half_pt && (base & 1))) base++;
        return (half)(sign | base);
    }
    // normal
    uint32_t base = mant >> 13;
    uint32_t rem = mant & 0x1fffu;
    if (rem > 0x1000u || (rem == 0x1000u && (base & 1))) {
        base++;
        if (base == 0x400u) { base = 0; exp++; if (exp >= 0x1f) return (half)(sign | 0x7c00u); }
    }
    return (half)(sign | ((uint32_t)exp << 10) | base);
}

float f16_to_f32(half h) {
    uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1fu;
    uint32_t mant = h & 0x3ffu;
    uint32_t x;
    if (exp == 0) {
        if (mant == 0) { x = sign; }
        else {
            int e = -1;
            do { e++; mant <<= 1; } while (!(mant & 0x400u));
            mant &= 0x3ffu;
            x = sign | ((uint32_t)(127 - 15 - e) << 23) | (mant << 13);
        }
    } else if (exp == 0x1f) {
        x = sign | 0x7f800000u | (mant << 13);
    } else {
        x = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &x, 4);
    return f;
}

inline int nearest_int(float f) {  // round half to even (ggml magic-trick parity)
    return (int)std::nearbyintf(f);
}

// ---------------------------------------------------------------- simple q

void q4_0_row(const float* x, uint8_t* dst, int64_t nblk) {
    for (int64_t b = 0; b < nblk; b++, x += 32, dst += 18) {
        float amax = 0, maxv = 0;
        for (int i = 0; i < 32; i++) { float a = std::fabs(x[i]); if (a > amax) { amax = a; maxv = x[i]; } }
        float d = maxv / -8.0f;
        float id = d ? 1.0f / d : 0.0f;
        half dh = f32_to_f16(d);
        std::memcpy(dst, &dh, 2);
        for (int i = 0; i < 16; i++) {
            int lo = std::min(15, (int)(x[i] * id + 8.5f));
            int hi = std::min(15, (int)(x[i + 16] * id + 8.5f));
            dst[2 + i] = (uint8_t)(lo | (hi << 4));
        }
    }
}

void q8_0_row(const float* x, uint8_t* dst, int64_t nblk) {
    for (int64_t b = 0; b < nblk; b++, x += 32, dst += 34) {
        float amax = 0;
        for (int i = 0; i < 32; i++) amax = std::max(amax, std::fabs(x[i]));
        float d = amax / 127.0f;
        float id = d ? 1.0f / d : 0.0f;
        half dh = f32_to_f16(d);
        std::memcpy(dst, &dh, 2);
        for (int i = 0; i < 32; i++) {
            dst[2 + i] = (uint8_t)(int8_t)std::roundf(x[i] * id);
        }
    }
}

// ------------------------------------------------------------- K-quant core

float make_qx_quants(int n, int nmax, const float* x, int8_t* L, const float* qw) {
    float maxv = 0, amax = 0;
    for (int i = 0; i < n; i++) { float a = std::fabs(x[i]); if (a > amax) { amax = a; maxv = x[i]; } }
    if (amax < 1e-15f) { std::memset(L, 0, n); return 0.0f; }
    float iscale = -nmax / maxv;
    float sumlx = 0, suml2 = 0;
    for (int i = 0; i < n; i++) {
        int l = std::clamp(nearest_int(iscale * x[i]), -nmax, nmax - 1);
        L[i] = (int8_t)l;
        float w = qw ? qw[i] : x[i] * x[i];
        sumlx += w * x[i] * l;
        suml2 += w * (float)l * l;
    }
    float scale = suml2 ? sumlx / suml2 : 0.0f;
    float best = scale * sumlx;
    for (int is = -9; is <= 9; is++) {
        if (is == 0) continue;
        float isc = -(nmax + 0.1f * is) / maxv;
        sumlx = suml2 = 0;
        std::vector<int8_t> Lt(n);
        for (int i = 0; i < n; i++) {
            int l = std::clamp(nearest_int(isc * x[i]), -nmax, nmax - 1);
            Lt[i] = (int8_t)l;
            float w = qw ? qw[i] : x[i] * x[i];
            sumlx += w * x[i] * l;
            suml2 += w * (float)l * l;
        }
        if (suml2 > 0 && sumlx * sumlx > best * suml2) {
            std::memcpy(L, Lt.data(), n);
            scale = sumlx / suml2;
            best = scale * sumlx;
        }
    }
    for (int i = 0; i < n; i++) L[i] += (int8_t)nmax;
    return scale;
}

float make_qkx2_quants(int n, int nmax, const float* x, const float* weights,
                       uint8_t* L, float* the_min, float rmin, float rdelta,
                       int nstep, bool use_mad) {
    float minv = x[0], maxv = x[0];
    float sum_w = weights[0], sum_x = weights[0] * x[0];
    for (int i = 1; i < n; i++) {
        minv = std::min(minv, x[i]);
        maxv = std::max(maxv, x[i]);
        sum_w += weights[i];
        sum_x += weights[i] * x[i];
    }
    if (minv > 0) minv = 0;
    if (maxv == minv) {
        std::memset(L, 0, n);
        *the_min = -minv;
        return 0.0f;
    }
    float iscale = nmax / (maxv - minv);
    float scale = 1.0f / iscale;
    float best_mad = 0;
    for (int i = 0; i < n; i++) {
        int l = std::clamp(nearest_int(iscale * (x[i] - minv)), 0, nmax);
        L[i] = (uint8_t)l;
        float diff = scale * l + minv - x[i];
        diff = use_mad ? std::fabs(diff) : diff * diff;
        best_mad += weights[i] * diff;
    }
    if (nstep < 1) { *the_min = -minv; return scale; }
    std::vector<uint8_t> Laux(n);
    for (int is = 0; is <= nstep; is++) {
        float isc = (rmin + rdelta * is + nmax) / (maxv - minv);
        float sum_l = 0, sum_l2 = 0, sum_xl = 0;
        for (int i = 0; i < n; i++) {
            int l = std::clamp(nearest_int(isc * (x[i] - minv)), 0, nmax);
            Laux[i] = (uint8_t)l;
            sum_l += weights[i] * l;
            sum_l2 += weights[i] * (float)l * l;
            sum_xl += weights[i] * l * x[i];
        }
        float D = sum_w * sum_l2 - sum_l * sum_l;
        if (D > 0) {
            float this_scale = (sum_w * sum_xl - sum_x * sum_l) / D;
            float this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D;
            if (this_min > 0) { this_min = 0; this_scale = sum_l2 ? sum_xl / sum_l2 : this_scale; }
            float mad = 0;
            for (int i = 0; i < n; i++) {
                float diff = this_scale * Laux[i] + this_min - x[i];
                diff = use_mad ? std::fabs(diff) : diff * diff;
                mad += weights[i] * diff;
            }
            if (mad < best_mad) {
                std::memcpy(L, Laux.data(), n);
                best_mad = mad;
                scale = this_scale;
                minv = this_min;
            }
        }
    }
    *the_min = -minv;
    return scale;
}

// ---------------------------------------------------------------- q4_K/q5_K

void get_scale_min_k4(int j, const uint8_t* q, uint8_t* dd, uint8_t* mm) {
    if (j < 4) { *dd = q[j] & 63; *mm = q[j + 4] & 63; }
    else {
        *dd = (q[j + 4] & 0xF) | ((q[j - 4] >> 6) << 4);
        *mm = (q[j + 4] >> 4) | ((q[j] >> 6) << 4);
    }
}

void q4_K_row(const float* x, uint8_t* dst, int64_t nblk, const float* qw_row) {
    float weights[32];
    uint8_t L[256], Lb[32];
    for (int64_t b = 0; b < nblk; b++, x += 256, dst += 144) {
        float scales[8], mins[8];
        float sumx2 = 0;
        for (int i = 0; i < 256; i++) sumx2 += x[i] * x[i];
        float sigma2 = 2.0f * sumx2 / 256;
        for (int j = 0; j < 8; j++) {
            const float* xb = x + 32 * j;
            if (qw_row) {
                const float* qj = qw_row + 256 * b + 32 * j;
                for (int l = 0; l < 32; l++) weights[l] = qj[l] * std::sqrt(sigma2 + xb[l] * xb[l]);
            } else {
                float av = 0;
                for (int l = 0; l < 32; l++) av += xb[l] * xb[l];
                av = std::sqrt(av / 32);
                for (int l = 0; l < 32; l++) weights[l] = av + std::fabs(xb[l]);
            }
            scales[j] = make_qkx2_quants(32, 15, xb, weights, Lb, &mins[j], -1.f, 0.1f, 20, false);
        }
        float max_scale = scales[0], max_min = mins[0];
        for (int j = 1; j < 8; j++) { max_scale = std::max(max_scale, scales[j]); max_min = std::max(max_min, mins[j]); }
        float inv_scale = max_scale > 0 ? 63.f / max_scale : 0.f;
        float inv_min = max_min > 0 ? 63.f / max_min : 0.f;
        uint8_t* sc = dst + 4;
        std::memset(sc, 0, 12);
        for (int j = 0; j < 8; j++) {
            uint8_t ls = (uint8_t)std::min(63, nearest_int(inv_scale * scales[j]));
            uint8_t lm = (uint8_t)std::min(63, nearest_int(inv_min * mins[j]));
            if (j < 4) { sc[j] = ls; sc[j + 4] = lm; }
            else { sc[j + 4] = (ls & 0xF) | ((lm & 0xF) << 4); sc[j - 4] |= (ls >> 4) << 6; sc[j] |= (lm >> 4) << 6; }
        }
        half dh = f32_to_f16(max_scale / 63.f), mh = f32_to_f16(max_min / 63.f);
        std::memcpy(dst, &dh, 2);
        std::memcpy(dst + 2, &mh, 2);
        float df = f16_to_f32(dh), mf = f16_to_f32(mh);
        for (int j = 0; j < 8; j++) {
            uint8_t sd, sm;
            get_scale_min_k4(j, sc, &sd, &sm);
            float dl = df * sd;
            if (!dl) { std::memset(L + 32 * j, 0, 32); continue; }
            float ml = mf * sm;
            for (int l = 0; l < 32; l++) {
                int v = nearest_int((x[32 * j + l] + ml) / dl);
                L[32 * j + l] = (uint8_t)std::clamp(v, 0, 15);
            }
        }
        uint8_t* q = dst + 16;
        for (int j = 0; j < 256; j += 64) {
            for (int l = 0; l < 32; l++) q[l] = (uint8_t)(L[j + l] | (L[j + l + 32] << 4));
            q += 32;
        }
    }
}

void q6_K_row(const float* x, uint8_t* dst, int64_t nblk, const float* qw_row) {
    int8_t Ls[16];
    int8_t Lq[16];
    uint8_t L[256];
    float qweights[16];
    for (int64_t b = 0; b < nblk; b++, x += 256, dst += 210) {
        float scales[16];
        float max_scale = 0, max_abs = 0;
        float sumx2 = 0;
        if (qw_row) { for (int i = 0; i < 256; i++) sumx2 += x[i] * x[i]; }
        float sigma2 = sumx2 / 256;
        for (int j = 0; j < 16; j++) {
            const float* xb = x + 16 * j;
            const float* qw = nullptr;
            if (qw_row) {
                const float* qj = qw_row + 256 * b + 16 * j;
                for (int l = 0; l < 16; l++) qweights[l] = qj[l] * std::sqrt(sigma2 + xb[l] * xb[l]);
                qw = qweights;
            }
            scales[j] = make_qx_quants(16, 32, xb, Lq, qw);
            float a = std::fabs(scales[j]);
            if (a > max_abs) { max_abs = a; max_scale = scales[j]; }
        }
        if (max_abs < 1e-15f) { std::memset(dst, 0, 210); continue; }
        float iscale = -128.f / max_scale;
        half dh = f32_to_f16(1.0f / iscale);
        float df = f16_to_f32(dh);
        for (int j = 0; j < 16; j++) Ls[j] = (int8_t)std::min(127, nearest_int(iscale * scales[j]));
        for (int j = 0; j < 256; j++) {
            float dl = df * Ls[j / 16];
            if (!dl) { L[j] = 0; continue; }
            int l = std::clamp(nearest_int(x[j] / dl), -32, 31);
            L[j] = (uint8_t)(l + 32);
        }
        uint8_t* ql = dst;
        uint8_t* qh = dst + 128;
        for (int j = 0; j < 256; j += 128) {
            for (int l = 0; l < 32; l++) {
                uint8_t q1 = L[j + l] & 0xF, q2 = L[j + l + 32] & 0xF;
                uint8_t q3 = L[j + l + 64] & 0xF, q4 = L[j + l + 96] & 0xF;
                ql[l] = (uint8_t)(q1 | (q3 << 4));
                ql[l + 32] = (uint8_t)(q2 | (q4 << 4));
                qh[l] = (uint8_t)((L[j + l] >> 4) | ((L[j + l + 32] >> 4) << 2) |
                                  ((L[j + l + 64] >> 4) << 4) | ((L[j + l + 96] >> 4) << 6));
            }
            ql += 64; qh += 32;
        }
        std::memcpy(dst + 192, Ls, 16);
        std::memcpy(dst + 208, &dh, 2);
    }
}

}  // namespace

extern "C" {

// qtype codes match GGMLType; returns 0 ok, -1 unsupported
int ggtpu_quantize(int qtype, const float* src, uint8_t* dst, int64_t n,
                   const float* quant_weights, int n_threads) {
    int64_t blk;
    void (*simple)(const float*, uint8_t*, int64_t) = nullptr;
    void (*krow)(const float*, uint8_t*, int64_t, const float*) = nullptr;
    int64_t bs, ts;
    switch (qtype) {
        case 2: simple = q4_0_row; bs = 32; ts = 18; break;   // Q4_0
        case 8: simple = q8_0_row; bs = 32; ts = 34; break;   // Q8_0
        case 12: krow = q4_K_row; bs = 256; ts = 144; break;  // Q4_K
        case 14: krow = q6_K_row; bs = 256; ts = 210; break;  // Q6_K
        default: return -1;
    }
    if (n % bs) return -2;
    blk = n / bs;
    int nt = std::max(1, std::min<int>(n_threads, (int)std::min<int64_t>(blk, 64)));
    std::vector<std::thread> threads;
    std::atomic<int64_t> next(0);
    const int64_t chunk = std::max<int64_t>(1, blk / (nt * 8));
    auto worker = [&]() {
        for (;;) {
            int64_t start = next.fetch_add(chunk);
            if (start >= blk) break;
            int64_t cnt = std::min(chunk, blk - start);
            if (simple) {
                simple(src + start * bs, dst + start * ts, cnt);
            } else {
                // krow indexes quant_weights by block relative to its base
                krow(src + start * bs, dst + start * ts, cnt,
                     quant_weights ? quant_weights + start * bs : nullptr);
            }
        }
    };
    for (int t = 0; t < nt; t++) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
    return 0;
}

int ggtpu_version() { return 1; }
}
