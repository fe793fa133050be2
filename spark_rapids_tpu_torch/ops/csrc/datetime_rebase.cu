// Proleptic-Gregorian <-> Julian rebase of DATE32 and TIMESTAMP_US columns,
// for Hopper (sm_90a): one thread a row.
//
// Replaces the XLA ops of spark_rapids_tpu/ops/datetime_rebase.py
// (`_greg_to_julian_days` :89, `_julian_to_greg_days` :97, `_rebase_micros`
// :113; no pallas_call). The reference's own CUDA is datetime_rebase.cu,
// one thread a row as here. A day before 1582-10-15 (day -141427) is read
// as a date in one calendar (Hinnant's civil or Julian algorithm) and
// written back as the same date in the other; a Gregorian date in
// 1582-10-05..14 goes to the Gregorian start. A micros value splits into
// its floor day and the microsecond of the day, the day narrowed to int32
// as the JAX package narrows it, and the two are put back together.
//
// Bit for bit with the JAX package: every division is its floor division
// (C's `/` truncates, so `dr_fdiv` rounds down itself), including where
// its `where` picks a negative dividend; the micros' reassembly wraps as
// XLA's int64 does (done in uint64: signed overflow is undefined in C++);
// a DATE32 result keeps its low 32 bits. The four forms (days or micros,
// each direction) are template parameters.
//
// What bounds it on this card: bytes. A row reads 4 or 8 bytes and writes
// as many; its arithmetic is some 60 integer operations (the divisions by
// constants become multiplies), under the bytes' time at the card's
// integer rate (chip_smoke.py counts the bound).
//
// The row functions are plain C++ too: without nvcc the qualifiers drop,
// and `host_rebase` below loops over rows as the kernel does, so that
// tests/test_torch_datetime_rebase.py builds this file with the host
// compiler and holds it against the plain version.
//
// Plain C interface for ctypes: the launcher returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for arguments it does not take);
// it neither synchronises nor allocates.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DR_FN __host__ __device__ __forceinline__
#else
#define DR_FN static inline
#endif

#define THREADS 256

typedef long long i64;
typedef unsigned long long u64;

static constexpr i64 DR_GREGORIAN_START_DAYS = -141427;
static constexpr i64 DR_LAST_SWITCH_MICROS = -12219292800000000LL;
static constexpr i64 DR_MICROS_PER_DAY = 86400000000LL;

// floor division by a positive constant
DR_FN i64 dr_fdiv(i64 a, i64 b) {
  const i64 q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

DR_FN i64 dr_day_of_year(i64 m, i64 d) {
  return dr_fdiv(153 * (m > 2 ? m - 3 : m + 9) + 2, 5) + d - 1;
}

// days since 1970-01-01 -> proleptic Gregorian (y, m, d)
DR_FN void dr_civil_from_days(i64 days, i64* y, i64* m, i64* d) {
  const i64 z = days + 719468;
  const i64 era = dr_fdiv(z >= 0 ? z : z - 146096, 146097);
  const i64 doe = z - era * 146097;
  const i64 yoe = dr_fdiv(doe - dr_fdiv(doe, 1460) + dr_fdiv(doe, 36524) -
                              dr_fdiv(doe, 146096),
                          365);
  const i64 doy = doe - (365 * yoe + dr_fdiv(yoe, 4) - dr_fdiv(yoe, 100));
  const i64 mp = dr_fdiv(5 * doy + 2, 153);
  *d = doy - dr_fdiv(153 * mp + 2, 5) + 1;
  *m = mp < 10 ? mp + 3 : mp - 9;
  *y = yoe + era * 400 + (*m <= 2 ? 1 : 0);
}

DR_FN i64 dr_days_from_civil(i64 y, i64 m, i64 d) {
  y -= m <= 2 ? 1 : 0;
  const i64 era = dr_fdiv(y >= 0 ? y : y - 399, 400);
  const i64 yoe = y - era * 400;
  const i64 doe =
      yoe * 365 + dr_fdiv(yoe, 4) - dr_fdiv(yoe, 100) + dr_day_of_year(m, d);
  return era * 146097 + doe - 719468;
}

DR_FN i64 dr_days_from_julian(i64 y, i64 m, i64 d) {
  const i64 year = y - (m <= 2 ? 1 : 0);
  const i64 era = dr_fdiv(year >= 0 ? year : year - 3, 4);
  const i64 yoe = year - era * 4;
  return era * 1461 + yoe * 365 + dr_day_of_year(m, d) - 719470;
}

// days since 1970-01-01 -> Julian (y, m, d)
DR_FN void dr_julian_from_days(i64 days, i64* y, i64* m, i64* d) {
  const i64 z = days + 719470;
  const i64 era = dr_fdiv(z >= 0 ? z : z - 1460, 1461);
  const i64 doe = z - era * 1461;
  const i64 yoe = dr_fdiv(doe - dr_fdiv(doe, 1460), 365);
  const i64 doy = doe - 365 * yoe;
  const i64 mp = dr_fdiv(5 * doy + 2, 153);
  *d = doy - dr_fdiv(153 * mp + 2, 5) + 1;
  *m = mp < 10 ? mp + 3 : mp - 9;
  *y = yoe + era * 4 + (*m <= 2 ? 1 : 0);
}

// the rebased day of an int32 day
template <bool TO_JULIAN>
DR_FN i64 dr_rebase_day(int32_t day) {
  const i64 days = day;
  if (days >= DR_GREGORIAN_START_DAYS) return days;
  i64 y, m, d;
  if (TO_JULIAN) {
    dr_civil_from_days(days, &y, &m, &d);
    if (y == 1582 && m == 10 && d >= 5 && d <= 14)
      return DR_GREGORIAN_START_DAYS;
    return dr_days_from_julian(y, m, d);
  }
  dr_julian_from_days(days, &y, &m, &d);
  return dr_days_from_civil(y, m, d);
}

template <bool TO_JULIAN>
DR_FN i64 dr_rebase_micros(i64 micros) {
  if (micros >= DR_LAST_SWITCH_MICROS) return micros;
  const i64 days = dr_fdiv(micros, DR_MICROS_PER_DAY);
  const i64 tod = micros - days * DR_MICROS_PER_DAY;
  const i64 day = dr_rebase_day<TO_JULIAN>(static_cast<int32_t>(days));
  return static_cast<i64>(static_cast<u64>(day) *
                              static_cast<u64>(DR_MICROS_PER_DAY) +
                          static_cast<u64>(tod));
}

template <bool MICROS, bool TO_JULIAN>
DR_FN void dr_row(const void* in, void* out, i64 i) {
  if (MICROS) {
    static_cast<i64*>(out)[i] =
        dr_rebase_micros<TO_JULIAN>(static_cast<const i64*>(in)[i]);
  } else {
    // the low 32 bits, as the JAX package's astype(int32)
    static_cast<int32_t*>(out)[i] = static_cast<int32_t>(static_cast<uint32_t>(
        static_cast<u64>(
            dr_rebase_day<TO_JULIAN>(static_cast<const int32_t*>(in)[i]))));
  }
}

#ifdef __CUDACC__

template <bool MICROS, bool TO_JULIAN>
__global__ void __launch_bounds__(THREADS)
dr_rebase_kernel(const void* in, i64 n, void* out) {
  const i64 stride = static_cast<i64>(gridDim.x) * blockDim.x;
  for (i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    dr_row<MICROS, TO_JULIAN>(in, out, i);
}

static int blocks_for(i64 n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const i64 need = (n + THREADS - 1) / THREADS;
  const i64 cap = static_cast<i64>(sms) * 16;
  return static_cast<int>(need < cap ? need : cap);
}

extern "C" {

// n >= 1 rows. micros: 1 for TIMESTAMP_US (int64 in and out), 0 for
// DATE32 (int32); to_julian: 1 Gregorian -> Julian, 0 the other way.
int dr_rebase(int micros, int to_julian, const void* in, long long n,
              void* out, void* stream) {
  if (n < 1 || in == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n);
  if (micros && to_julian)
    dr_rebase_kernel<true, true><<<blocks, THREADS, 0, s>>>(in, n, out);
  else if (micros)
    dr_rebase_kernel<true, false><<<blocks, THREADS, 0, s>>>(in, n, out);
  else if (to_julian)
    dr_rebase_kernel<false, true><<<blocks, THREADS, 0, s>>>(in, n, out);
  else
    dr_rebase_kernel<false, false><<<blocks, THREADS, 0, s>>>(in, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#else  // the host build of the row functions, for the tests

extern "C" int host_rebase(int micros, int to_julian, const void* in,
                           long long n, void* out) {
  if (n < 0 || (n > 0 && (in == nullptr || out == nullptr))) return 1;
  for (i64 i = 0; i < n; ++i) {
    if (micros && to_julian)
      dr_row<true, true>(in, out, i);
    else if (micros)
      dr_row<true, false>(in, out, i);
    else if (to_julian)
      dr_row<false, true>(in, out, i);
    else
      dr_row<false, false>(in, out, i);
  }
  return 0;
}

#endif  // __CUDACC__
