// lam_native: threaded binary IO + generator kernels for lam_tpu.
//
// Native-code counterpart of the reference's C++ data plane: the MPI-IO
// sharded matrix reads (ConjugateGradient_CPU_MPI_OMP.hpp:325-363, and the
// pinned-buffer loads in ConjugateGradient_MultiGPUS_CUDA_MPI.cu:470-516)
// and the gen-mode tridiagonal fill (CPU_MPI_OMP.hpp:237-247). The
// host's job is feeding the device: these routines stream row-blocks off the
// filesystem with per-thread pread() and convert f64 -> float-float
// (hi, lo) planes in the same pass, so the host never materializes a
// second copy of a multi-GB matrix.
//
// Exposed as a plain C ABI consumed via ctypes (lam_tpu/_native_io.py);
// falls back to numpy transparently when this library is not built.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kHeaderBytes = 16;  // two little-endian uint64

int num_io_threads(uint64_t bytes) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 4;
    // one thread per ~64 MB, capped by cores
    uint64_t want = bytes / (64ull << 20) + 1;
    return static_cast<int>(want < hw ? want : hw);
}

// pread the byte range [off, off+len) into dst, handling short reads.
bool pread_all(int fd, void* dst, uint64_t len, uint64_t off) {
    char* p = static_cast<char*>(dst);
    while (len > 0) {
        ssize_t got = ::pread(fd, p, len, static_cast<off_t>(off));
        if (got <= 0) return false;
        p += got;
        off += static_cast<uint64_t>(got);
        len -= static_cast<uint64_t>(got);
    }
    return true;
}

template <typename Fn>
void parallel_chunks(uint64_t count, uint64_t bytes_hint, Fn fn) {
    int nt = num_io_threads(bytes_hint);
    if (nt <= 1 || count < 2) {
        fn(0, count);
        return;
    }
    std::vector<std::thread> ts;
    uint64_t chunk = (count + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        uint64_t lo = t * chunk;
        if (lo >= count) break;
        uint64_t hi = lo + chunk < count ? lo + chunk : count;
        ts.emplace_back([=] { fn(lo, hi); });
    }
    for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Read rows [row_start, row_start+num_rows) of a (rows, cols) f64 matrix
// file (reference binary format) into out. Returns 0 on success.
int ln_read_rows(const char* path, uint64_t row_start, uint64_t num_rows,
                 uint64_t cols, double* out) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return 1;
    uint64_t row_bytes = cols * sizeof(double);
    uint64_t base = kHeaderBytes + row_start * row_bytes;
    // written from worker threads, read after join and in their
    // loop guards - atomic avoids the cross-thread data race
    std::atomic<bool> ok{true};
    parallel_chunks(num_rows, num_rows * row_bytes,
                    [&](uint64_t lo, uint64_t hi) {
        if (!pread_all(fd, out + lo * cols, (hi - lo) * row_bytes,
                       base + lo * row_bytes))
            ok = false;
    });
    ::close(fd);
    return ok ? 0 : 2;
}

// Same read, but emit float-float planes: hi = (float)v,
// lo = (float)(v - (double)hi). Streams in per-thread row chunks; no
// full-size f64 buffer is ever allocated.
int ln_read_rows_split(const char* path, uint64_t row_start,
                       uint64_t num_rows, uint64_t cols, float* hi,
                       float* lo) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return 1;
    uint64_t row_bytes = cols * sizeof(double);
    uint64_t base = kHeaderBytes + row_start * row_bytes;
    // written from worker threads, read after join and in their
    // loop guards - atomic avoids the cross-thread data race
    std::atomic<bool> ok{true};
    parallel_chunks(num_rows, num_rows * row_bytes,
                    [&](uint64_t r0, uint64_t r1) {
        std::vector<double> buf(cols);
        for (uint64_t r = r0; r < r1 && ok; ++r) {
            if (!pread_all(fd, buf.data(), row_bytes,
                           base + r * row_bytes)) {
                ok = false;
                break;
            }
            float* h = hi + r * cols;
            float* l = lo + r * cols;
            for (uint64_t c = 0; c < cols; ++c) {
                float f = static_cast<float>(buf[c]);
                h[c] = f;
                l[c] = static_cast<float>(buf[c]
                                          - static_cast<double>(f));
            }
        }
    });
    ::close(fd);
    return ok ? 0 : 2;
}

// Split an in-memory f64 array into (hi, lo) f32 planes, threaded.
void ln_split_f64(const double* src, uint64_t n, float* hi, float* lo) {
    parallel_chunks(n, n * sizeof(double), [&](uint64_t i0, uint64_t i1) {
        for (uint64_t i = i0; i < i1; ++i) {
            float f = static_cast<float>(src[i]);
            hi[i] = f;
            lo[i] = static_cast<float>(src[i] - static_cast<double>(f));
        }
    });
}

// Write a (rows, cols) f64 matrix in the reference binary format
// (random_spd_system.cpp:105-121). Returns 0 on success.
int ln_write_matrix(const char* path, uint64_t rows, uint64_t cols,
                    const double* data) {
    FILE* f = ::fopen(path, "wb");
    if (!f) return 1;
    uint64_t hdr[2] = {rows, cols};
    bool ok = ::fwrite(hdr, sizeof(hdr), 1, f) == 1;
    uint64_t n = rows * cols;
    ok = ok && ::fwrite(data, sizeof(double), n, f) == n;
    return ::fclose(f) == 0 && ok ? 0 : 2;
}

// Gen-mode dense tridiagonal row block: 2 on the diagonal, 1 off
// (ConjugateGradient_CPU_MPI_OMP.hpp:237-247), threaded fill.
void ln_tridiagonal_rows(uint64_t row_start, uint64_t num_rows, uint64_t n,
                         double* out) {
    parallel_chunks(num_rows, num_rows * n * sizeof(double),
                    [&](uint64_t r0, uint64_t r1) {
        std::memset(out + r0 * n, 0, (r1 - r0) * n * sizeof(double));
        for (uint64_t r = r0; r < r1; ++r) {
            uint64_t i = row_start + r;
            if (i >= n) continue;  // padded rows stay zero
            out[r * n + i] = 2.0;
            if (i > 0) out[r * n + i - 1] = 1.0;
            if (i + 1 < n) out[r * n + i + 1] = 1.0;
        }
    });
}

// Smallest power of two >= m / 32767 (the dfq per-tile quantization
// scale). frexp-exact — no libm log2 rounding at power-of-two
// boundaries — and mirrored bit-for-bit by the numpy fallback
// (lam_tpu/ops/gemv.py quantize_lo_tiles).
static float ln_q_scale(float m) {
    if (m == 0.0f) return 0.0f;
    int k;
    double fr = std::frexp(static_cast<double>(m) / 32767.0, &k);
    int e = (fr == 0.5) ? k - 1 : k;
    return static_cast<float>(std::ldexp(1.0, e));
}

// Stream a symmetric (n, n) f64 matrix (raw data at byte `data_off` of
// `path`, row-major) directly into the quantized-lo packed triangle
// layout of DenseOperator.from_dense_dfq (lam_tpu/solver/operators.py):
// walk-order (T*tb, tb) f32 hi tiles + int16 lo tiles against per-tile
// power-of-two scales, diagonal extracted to f32 (dh, dl) float-float
// pairs of length n_pad. One fused pass — read, split, max, quantize —
// and only the LOWER-TRIANGLE bytes are read (cols <= (i+1)*tb per tile
// row): ~half the disk traffic and none of the numpy temporaries of the
// Python pack. The reference's analog is the MPI-IO sharded load
// (ConjugateGradient_CPU_MPI_OMP.hpp:325-363); quantization has no
// reference analog (fp64-square storage throughout).
int ln_pack_dfq(const char* path, uint64_t data_off, uint64_t n,
                uint64_t n_pad, uint64_t tb, float* hi, int16_t* loq,
                float* sc, float* dh, float* dl) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return 1;
    uint64_t nblk = n_pad / tb;
    std::memset(dh, 0, n_pad * sizeof(float));
    std::memset(dl, 0, n_pad * sizeof(float));
    // written from worker threads, read after join and in their
    // loop guards - atomic avoids the cross-thread data race
    std::atomic<bool> ok{true};
    // chunked over tile-rows; row i holds i+1 tiles, so later chunks are
    // heavier — acceptable (the 1-core common case runs one chunk, and
    // IO dominates multi-core)
    parallel_chunks(nblk, n_pad * n_pad / 2 * sizeof(double),
                    [&](uint64_t i0, uint64_t i1) {
        std::vector<double> buf;
        std::vector<float> lob(tb * tb);
        for (uint64_t i = i0; i < i1 && ok; ++i) {
            uint64_t w = (i + 1) * tb;           // padded tile-row width
            uint64_t cw = w < n ? w : n;         // file columns present
            uint64_t r0 = i * tb;
            uint64_t src = n > r0 ? (n - r0 < tb ? n - r0 : tb) : 0;
            buf.assign(tb * w, 0.0);
            for (uint64_t r = 0; r < src && ok; ++r) {
                if (!pread_all(fd, buf.data() + r * w,
                               cw * sizeof(double),
                               data_off + (r0 + r) * n * sizeof(double)))
                    ok = false;
            }
            if (!ok) break;
            for (uint64_t r = 0; r < src; ++r) {
                double v = buf[r * w + r0 + r];
                float h = static_cast<float>(v);
                dh[r0 + r] = h;
                dl[r0 + r] = static_cast<float>(
                    v - static_cast<double>(h));
                buf[r * w + r0 + r] = 0.0;       // planes carry 0 there
            }
            uint64_t t0 = i * (i + 1) / 2;
            for (uint64_t k = 0; k <= i; ++k) {
                float* ht = hi + (t0 + k) * tb * tb;
                int16_t* qt = loq + (t0 + k) * tb * tb;
                // separate single-purpose loops so the compiler
                // vectorizes each (the fused scalar form measured
                // SLOWER than numpy's SIMD passes)
                for (uint64_t r = 0; r < tb; ++r) {
                    const double* s = buf.data() + r * w + k * tb;
                    float* hrow = ht + r * tb;
                    float* lrow = lob.data() + r * tb;
                    for (uint64_t c = 0; c < tb; ++c)
                        hrow[c] = static_cast<float>(s[c]);
                    for (uint64_t c = 0; c < tb; ++c)
                        lrow[c] = static_cast<float>(
                            s[c] - static_cast<double>(hrow[c]));
                }
                // abs-max as an unsigned-int max reduction (IEEE abs
                // compare == integer compare with the sign bit cleared;
                // finite inputs only) — vectorizes without fast-math
                uint32_t mbits = 0;
                const uint32_t* lb =
                    reinterpret_cast<const uint32_t*>(lob.data());
                for (uint64_t e = 0; e < tb * tb; ++e) {
                    uint32_t b = lb[e] & 0x7fffffffu;
                    if (b > mbits) mbits = b;
                }
                float m;
                std::memcpy(&m, &mbits, sizeof(m));
                float scale = ln_q_scale(m);
                sc[t0 + k] = scale;
                if (scale == 0.0f) {
                    std::memset(qt, 0, tb * tb * sizeof(int16_t));
                    continue;
                }
                // divide == multiply by the exact power-of-two inverse
                double inv = 1.0 / static_cast<double>(scale);
                for (uint64_t e = 0; e < tb * tb; ++e) {
                    double q = __builtin_rint(
                        static_cast<double>(lob[e]) * inv);
                    if (q > 32767.0) q = 32767.0;
                    if (q < -32767.0) q = -32767.0;
                    qt[e] = static_cast<int16_t>(q);
                }
            }
        }
    });
    ::close(fd);
    return ok ? 0 : 2;
}

// f64 variant of ln_q_scale (the fq cascade quantizes f64 residuals
// directly; mirrored bit-for-bit by lam_tpu/ops/gemv.py
// quantize_fq_tiles, which takes the abs-max in f64 too).
static float ln_q_scale_d(double m) {
    if (m == 0.0) return 0.0f;
    int k;
    double fr = std::frexp(m / 32767.0, &k);
    int e = (fr == 0.5) ? k - 1 : k;
    return static_cast<float>(std::ldexp(1.0, e));
}

// Stream a symmetric f64 matrix file into the FULLY-quantized packed
// triangle layout of DenseOperator.from_dense_fq: three int16 cascade
// planes against per-tile power-of-two scales (q1 + q2 + q3, each
// capturing the residual of the previous level; ~2^-48 tile-relative
// total) + the diagonal extracted to an (dh, dl) float-float pair.
// Same framing as ln_pack_dfq above: one fused pass, only the
// lower-triangle bytes read.
//
// ln_pack_fq_range packs tile-rows [i0, i1) only, into the FULL-plane
// output pointers; diagonal entries outside the range are untouched.
// Python drives it chunk-by-chunk (the GIL drops across the ctypes
// call) so quantization of chunk i+1 overlaps the device upload of
// chunk i — the cold-path load pipeline (solver/operators.py
// _pack_fq_streamed). ln_pack_fq == range(0, nblk) + the dh/dl memset.
int ln_pack_fq_range(const char* path, uint64_t data_off, uint64_t n,
                     uint64_t n_pad, uint64_t tb, uint64_t row0,
                     uint64_t row1, int16_t* q1, int16_t* q2,
                     int16_t* q3, float* s1, float* s2, float* s3,
                     float* dh, float* dl) {
    (void)n_pad;  // kept for API symmetry with ln_pack_fq
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return 1;
    std::atomic<bool> ok{true};
    parallel_chunks(row1 - row0,
                    (row1 * row1 - row0 * row0) / 2 * tb * tb
                        * sizeof(double),
                    [&](uint64_t c0, uint64_t c1) {
        std::vector<double> buf;
        std::vector<double> rbuf(tb * tb);
        for (uint64_t i = row0 + c0; i < row0 + c1 && ok; ++i) {
            uint64_t w = (i + 1) * tb;
            uint64_t cw = w < n ? w : n;
            uint64_t r0 = i * tb;
            uint64_t src = n > r0 ? (n - r0 < tb ? n - r0 : tb) : 0;
            buf.assign(tb * w, 0.0);
            for (uint64_t r = 0; r < src && ok; ++r) {
                if (!pread_all(fd, buf.data() + r * w,
                               cw * sizeof(double),
                               data_off + (r0 + r) * n * sizeof(double)))
                    ok = false;
            }
            if (!ok) break;
            for (uint64_t r = 0; r < src; ++r) {
                double v = buf[r * w + r0 + r];
                float h = static_cast<float>(v);
                dh[r0 + r] = h;
                dl[r0 + r] = static_cast<float>(
                    v - static_cast<double>(h));
                buf[r * w + r0 + r] = 0.0;       // planes carry 0 there
            }
            uint64_t t0 = i * (i + 1) / 2;
            for (uint64_t k = 0; k <= i; ++k) {
                for (uint64_t r = 0; r < tb; ++r)
                    std::memcpy(rbuf.data() + r * tb,
                                buf.data() + r * w + k * tb,
                                tb * sizeof(double));
                int16_t* qs[3] = {q1 + (t0 + k) * tb * tb,
                                  q2 + (t0 + k) * tb * tb,
                                  q3 + (t0 + k) * tb * tb};
                float* ss[3] = {s1 + t0 + k, s2 + t0 + k, s3 + t0 + k};
                for (int lvl = 0; lvl < 3; ++lvl) {
                    // f64 abs-max via the sign-cleared integer trick
                    uint64_t mbits = 0;
                    const uint64_t* rb = reinterpret_cast<const uint64_t*>(
                        rbuf.data());
                    for (uint64_t e = 0; e < tb * tb; ++e) {
                        uint64_t b = rb[e] & 0x7fffffffffffffffull;
                        if (b > mbits) mbits = b;
                    }
                    double m;
                    std::memcpy(&m, &mbits, sizeof(m));
                    float scale = ln_q_scale_d(m);
                    *ss[lvl] = scale;
                    int16_t* qt = qs[lvl];
                    if (scale == 0.0f) {       // residual identically 0
                        std::memset(qt, 0, tb * tb * sizeof(int16_t));
                        continue;
                    }
                    double sd = static_cast<double>(scale);
                    double inv = 1.0 / sd;
                    for (uint64_t e = 0; e < tb * tb; ++e) {
                        double q = __builtin_rint(rbuf[e] * inv);
                        if (q > 32767.0) q = 32767.0;
                        if (q < -32767.0) q = -32767.0;
                        qt[e] = static_cast<int16_t>(q);
                    }
                    for (uint64_t e = 0; e < tb * tb; ++e)
                        rbuf[e] -= static_cast<double>(qt[e]) * sd;
                }
            }
        }
    });
    ::close(fd);
    return ok ? 0 : 2;
}

int ln_pack_fq(const char* path, uint64_t data_off, uint64_t n,
               uint64_t n_pad, uint64_t tb, int16_t* q1, int16_t* q2,
               int16_t* q3, float* s1, float* s2, float* s3,
               float* dh, float* dl) {
    std::memset(dh, 0, n_pad * sizeof(float));
    std::memset(dl, 0, n_pad * sizeof(float));
    return ln_pack_fq_range(path, data_off, n, n_pad, tb, 0, n_pad / tb,
                            q1, q2, q3, s1, s2, s3, dh, dl);
}

// Stream a symmetric f64 matrix file into the UNQUANTIZED packed
// triangle f32 plane layout of DenseOperator.from_dense with
// engine='pallas_symm_packed' (lam_tpu/solver/operators.py): walk-order
// (T*tb, tb) f32 hi tiles, plus the df64 lo plane (f32 of the f64
// remainder) when `lo` is non-null. Unlike ln_pack_dfq/fq the diagonal
// STAYS in the plane (the f32/df64 symm kernels read it there) and
// there are no scales. Bit-identical to the numpy path (a.astype(f32),
// lo = f32(a - f64(hi))). One fused pass; only the lower-triangle
// bytes are read — ~half the disk traffic of the full-square load the
// f32/df64 file path previously required. The reference's analog is
// the MPI-IO sharded load (ConjugateGradient_CPU_MPI_OMP.hpp:325-363).
int ln_pack_planes(const char* path, uint64_t data_off, uint64_t n,
                   uint64_t n_pad, uint64_t tb, float* hi, float* lo) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return 1;
    uint64_t nblk = n_pad / tb;
    std::atomic<bool> ok{true};
    parallel_chunks(nblk, n_pad * n_pad / 2 * sizeof(double),
                    [&](uint64_t i0, uint64_t i1) {
        std::vector<double> buf;
        for (uint64_t i = i0; i < i1 && ok; ++i) {
            uint64_t w = (i + 1) * tb;           // padded tile-row width
            uint64_t cw = w < n ? w : n;         // file columns present
            uint64_t r0 = i * tb;
            uint64_t src = n > r0 ? (n - r0 < tb ? n - r0 : tb) : 0;
            buf.assign(tb * w, 0.0);
            for (uint64_t r = 0; r < src && ok; ++r) {
                if (!pread_all(fd, buf.data() + r * w,
                               cw * sizeof(double),
                               data_off + (r0 + r) * n * sizeof(double)))
                    ok = false;
            }
            if (!ok) break;
            uint64_t t0 = i * (i + 1) / 2;
            for (uint64_t k = 0; k <= i; ++k) {
                float* ht = hi + (t0 + k) * tb * tb;
                float* lt = lo ? lo + (t0 + k) * tb * tb : nullptr;
                for (uint64_t r = 0; r < tb; ++r) {
                    const double* s = buf.data() + r * w + k * tb;
                    float* hrow = ht + r * tb;
                    for (uint64_t c = 0; c < tb; ++c)
                        hrow[c] = static_cast<float>(s[c]);
                    if (lt) {
                        float* lrow = lt + r * tb;
                        for (uint64_t c = 0; c < tb; ++c)
                            lrow[c] = static_cast<float>(
                                s[c] - static_cast<double>(hrow[c]));
                    }
                }
            }
        }
    });
    ::close(fd);
    return ok ? 0 : 2;
}

// Tridiagonal row block split directly into (hi, lo) planes (the values
// 0/1/2 are exact in f32, so lo is zero — kept general anyway).
void ln_tridiagonal_rows_split(uint64_t row_start, uint64_t num_rows,
                               uint64_t n, float* hi, float* lo) {
    parallel_chunks(num_rows, num_rows * n * sizeof(float) * 2,
                    [&](uint64_t r0, uint64_t r1) {
        std::memset(hi + r0 * n, 0, (r1 - r0) * n * sizeof(float));
        std::memset(lo + r0 * n, 0, (r1 - r0) * n * sizeof(float));
        for (uint64_t r = r0; r < r1; ++r) {
            uint64_t i = row_start + r;
            if (i >= n) continue;
            hi[r * n + i] = 2.0f;
            if (i > 0) hi[r * n + i - 1] = 1.0f;
            if (i + 1 < n) hi[r * n + i + 1] = 1.0f;
        }
    });
}

}  // extern "C"
