// Threaded particle-stack reader for cryo_ralib_tpu.
//
// Native runtime component filling the data-loader role the reference
// implements in C++/CUDA (its ctypes-driven gpu_aln_pack.so pipeline and
// the per-image cudaMemcpy2D upload path, cuda/gpu_aln_noref.cu:1712-1773).
// On the GPU host the device upload is jax.device_put; what remains hot on the
// host is decoding hundreds of thousands of MRC slices from disk into the
// float32 staging buffer — fread+astype in Python is single-threaded and
// copies twice.  This library does positioned reads (pread) of arbitrary
// slice subsets across a thread pool and converts MRC modes
// (int8/int16/float32/uint16/half) to float32 in place.
//
// C ABI only; bound from Python via ctypes (cryo_ralib_tpu/native).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr long kHeaderSize = 1024;

struct MrcInfo {
  long nx = 0, ny = 0, nz = 0, mode = 0;
  long data_offset = 0;
};

int parse_header(const char* path, MrcInfo* info) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  unsigned char raw[kHeaderSize];
  ssize_t got = ::pread(fd, raw, kHeaderSize, 0);
  ::close(fd);
  if (got != kHeaderSize) return -EIO;
  int32_t ints[25];
  std::memcpy(ints, raw, sizeof(ints));
  info->nx = ints[0];
  info->ny = ints[1];
  info->nz = ints[2];
  info->mode = ints[3];
  int32_t nsymbt = ints[23];
  info->data_offset = kHeaderSize + nsymbt;
  if (info->nx <= 0 || info->ny <= 0 || info->nz < 0) return -EINVAL;
  return 0;
}

long dtype_size(long mode) {
  switch (mode) {
    case 0: return 1;   // int8
    case 1: return 2;   // int16
    case 2: return 4;   // float32
    case 6: return 2;   // uint16
    case 12: return 2;  // half
    default: return -1;
  }
}

float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t frac = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (frac == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      int shift = 0;
      while (!(frac & 0x400)) {
        frac <<= 1;
        ++shift;
      }
      frac &= 0x3ff;
      bits = sign | ((127 - 15 - shift + 1) << 23) | (frac << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (frac << 13);  // inf/nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (frac << 13);
  }
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

void convert(const unsigned char* src, float* dst, long n, long mode) {
  switch (mode) {
    case 0: {
      const int8_t* p = reinterpret_cast<const int8_t*>(src);
      for (long i = 0; i < n; ++i) dst[i] = (float)p[i];
      break;
    }
    case 1: {
      const int16_t* p = reinterpret_cast<const int16_t*>(src);
      for (long i = 0; i < n; ++i) dst[i] = (float)p[i];
      break;
    }
    case 2:
      std::memcpy(dst, src, (size_t)n * 4);
      break;
    case 6: {
      const uint16_t* p = reinterpret_cast<const uint16_t*>(src);
      for (long i = 0; i < n; ++i) dst[i] = (float)p[i];
      break;
    }
    case 12: {
      const uint16_t* p = reinterpret_cast<const uint16_t*>(src);
      for (long i = 0; i < n; ++i) dst[i] = half_to_float(p[i]);
      break;
    }
  }
}

}  // namespace

extern "C" {

// Fills out5 = [nx, ny, nz, mode, data_offset]; returns 0 or -errno.
long cr_stack_info(const char* path, long* out5) {
  MrcInfo info;
  int rc = parse_header(path, &info);
  if (rc != 0) return rc;
  out5[0] = info.nx;
  out5[1] = info.ny;
  out5[2] = info.nz;
  out5[3] = info.mode;
  out5[4] = info.data_offset;
  return 0;
}

// Reads `count` z-slices given by `indices` into `out` (count*ny*nx
// float32, row-major).  Threaded over slices.  Returns 0 or -errno.
long cr_read_slices(const char* path, const long* indices, long count,
                    float* out) {
  MrcInfo info;
  int rc = parse_header(path, &info);
  if (rc != 0) return rc;
  long dsz = dtype_size(info.mode);
  if (dsz < 0) return -ENOTSUP;
  const long item = info.nx * info.ny;
  const long stride = item * dsz;

  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads == 0) n_threads = 4;
  if ((long)n_threads > count) n_threads = (unsigned)count;
  if (n_threads > 32) n_threads = 32;

  std::atomic<long> next(0);
  std::atomic<long> err(0);
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (unsigned t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      int fd = ::open(path, O_RDONLY);
      if (fd < 0) {
        err.store(-errno);
        return;
      }
      std::vector<unsigned char> buf((size_t)stride);
      for (;;) {
        long j = next.fetch_add(1);
        if (j >= count || err.load() != 0) break;
        long idx = indices[j];
        if (idx < 0 || idx >= info.nz) {
          err.store(-ERANGE);
          break;
        }
        off_t off = (off_t)info.data_offset + (off_t)idx * stride;
        long done = 0;
        while (done < stride) {
          ssize_t got = ::pread(fd, buf.data() + done, stride - done,
                                off + done);
          if (got <= 0) {
            err.store(got == 0 ? -EIO : -errno);
            break;
          }
          done += got;
        }
        if (err.load() != 0) break;
        convert(buf.data(), out + (size_t)j * item, item, info.mode);
      }
      ::close(fd);
    });
  }
  for (auto& th : pool) th.join();
  return err.load();
}

long cr_version() { return 1; }

}  // extern "C"
