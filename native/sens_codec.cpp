// Native .sens frame decoding for the host data path.
//
// The reference's offline input path decompresses per-frame zlib uint16
// depth + JPEG color on dedicated prefetch threads (SensorDataReader.cpp
// RGBDFrameCacheRead). This library provides this engine's equivalent:
// multithreaded zlib inflation + uint16->float depth conversion, exposed
// through a C ABI consumed via ctypes (bundlefusion_tpu/io/native.py).
// JPEG color decode stays in Python (cv2, imported only for JPEG input).
//
// Built on first use by io/native.py, or by hand: make -C native

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// Inflate a zlib stream of uint16 depth values. Returns the number of
// uint16 values written, or -1 on error.
long bf_inflate_u16(const uint8_t* src, size_t src_len, uint16_t* dst,
                    size_t dst_capacity_values) {
  uLongf dst_bytes = static_cast<uLongf>(dst_capacity_values * 2);
  int rc = uncompress(reinterpret_cast<Bytef*>(dst), &dst_bytes,
                      reinterpret_cast<const Bytef*>(src),
                      static_cast<uLong>(src_len));
  if (rc != Z_OK) return -1;
  return static_cast<long>(dst_bytes / 2);
}

// uint16 depth -> float meters; 0 becomes NaN (the reference's MINF).
void bf_depth_to_float(const uint16_t* src, float* dst, size_t n,
                       float inv_shift) {
  const float nanv = std::nanf("");
  for (size_t i = 0; i < n; ++i) {
    uint16_t v = src[i];
    dst[i] = v ? static_cast<float>(v) * inv_shift : nanv;
  }
}

// Decode a batch of zlib depth frames in parallel into a contiguous float
// output [n_frames, n_pixels]. srcs/lens describe the compressed buffers.
// Returns 0 on success, else the index+1 of the first failed frame.
int bf_decode_depth_batch(const uint8_t** srcs, const size_t* lens,
                          float* dst, int n_frames, int n_pixels,
                          float depth_shift, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  const float inv_shift = 1.0f / depth_shift;
  std::vector<int> errors(n_threads, 0);
  auto worker = [&](int tid) {
    std::vector<uint16_t> tmp(n_pixels);
    for (int f = tid; f < n_frames; f += n_threads) {
      long got = bf_inflate_u16(srcs[f], lens[f], tmp.data(), n_pixels);
      if (got != n_pixels) {
        if (!errors[tid]) errors[tid] = f + 1;
        continue;
      }
      bf_depth_to_float(tmp.data(), dst + static_cast<size_t>(f) * n_pixels,
                        n_pixels, inv_shift);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();
  for (int e : errors)
    if (e) return e;
  return 0;
}

// Deflate uint16 depth for recording (reference recording path).
long bf_deflate_u16(const uint16_t* src, size_t n_values, uint8_t* dst,
                    size_t dst_capacity_bytes) {
  uLongf out_len = static_cast<uLongf>(dst_capacity_bytes);
  int rc = compress2(reinterpret_cast<Bytef*>(dst), &out_len,
                     reinterpret_cast<const Bytef*>(src),
                     static_cast<uLong>(n_values * 2), Z_BEST_SPEED);
  if (rc != Z_OK) return -1;
  return static_cast<long>(out_len);
}

}  // extern "C"
