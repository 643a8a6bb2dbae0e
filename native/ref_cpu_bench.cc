// Single-core CPU baseline: the reference's decimateii workload.
//
// sdrangelbench (sdrbench/mainbench.cpp:69-110) times
// Decimators<qint32,qint16,...>::decimate64_cen over random int16 buffers —
// a cascade of 6 half-band order-64 decimators (inthalfbandfiltereo.h), each
// computing per output 16 symmetric coefficient MACs + centre tap per I/Q
// rail with int32 accumulation and a Q12 shift. Qt isn't available in this
// image, so this standalone program implements the same arithmetic (same
// filter order, same fixed-point format, same per-output operation count) to
// fix the single-core kS/s number the framework is measured against.
//
// Build: g++ -O3 -march=native -o ref_cpu_bench ref_cpu_bench.cc
// Run:   ./ref_cpu_bench [nsamples] [repeat]   (defaults 1048576, 10)
// Output: one JSON line {"ksps": ...}

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

namespace {

// Order-64 half-band: 16 unique side coefficients in Q12
// (values: hbfiltertraits.cpp HBFIRFilterTraits<64>, shift 12).
constexpr int kShift = 12;
constexpr int32_t kCoef[16] = {
    (int32_t)(-0.0004653050334792540 * (1 << kShift)),
    (int32_t)(0.0007120490624526884 * (1 << kShift)),
    (int32_t)(-0.0012303473710125559 * (1 << kShift)),
    (int32_t)(0.0019716520179919018 * (1 << kShift)),
    (int32_t)(-0.0029947484165425580 * (1 << kShift)),
    (int32_t)(0.0043703902150498061 * (1 << kShift)),
    (int32_t)(-0.0061858352927315653 * (1 << kShift)),
    (int32_t)(0.0085554408639278122 * (1 << kShift)),
    (int32_t)(-0.0116397924445187356 * (1 << kShift)),
    (int32_t)(0.0156852221106748395 * (1 << kShift)),
    (int32_t)(-0.0211070832238078286 * (1 << kShift)),
    (int32_t)(0.0286850846890029897 * (1 << kShift)),
    (int32_t)(-0.0400956173930921908 * (1 << kShift)),
    (int32_t)(0.0597215923200692667 * (1 << kShift)),
    (int32_t)(-0.1036982054813635201 * (1 << kShift)),
    (int32_t)(0.3175014394028848885 * (1 << kShift)),
};

// One ×2 half-band decimation stage for interleaved I/Q int32 samples.
// Double-written ring buffer keeps the FIR window contiguous (the same
// trick as the reference's even/odd double arrays) so the inner loop is a
// straight 16-tap MAC per rail.
class HalfbandDecimator {
 public:
  HalfbandDecimator() { std::memset(buf_, 0, sizeof(buf_)); pos_ = 0; phase_ = 0; }

  // Feed one complex sample; returns true and fills out when an output is due.
  inline bool feed(int32_t i, int32_t q, int32_t* oi, int32_t* oq) {
    buf_[2 * pos_] = i;
    buf_[2 * pos_ + 1] = q;
    buf_[2 * (pos_ + kTaps)] = i;
    buf_[2 * (pos_ + kTaps) + 1] = q;
    pos_ = (pos_ + 1) % kTaps;
    phase_ ^= 1;
    if (phase_) return false;
    // window = last 63 samples ending at the newest; odd offsets carry the
    // 16 symmetric coefficient pairs, centre tap is 0.5.
    const int32_t* w = &buf_[2 * pos_];  // oldest sample of the window
    int64_t acc_i = 0, acc_q = 0;
    for (int k = 0; k < 16; ++k) {
      const int a = 2 * k;          // tap offset 2k (even index = odd offset pair lo)
      const int b = 62 - 2 * k;     // mirrored tap
      acc_i += (int64_t)kCoef[k] * ((int64_t)w[2 * a] + w[2 * b]);
      acc_q += (int64_t)kCoef[k] * ((int64_t)w[2 * a + 1] + w[2 * b + 1]);
    }
    acc_i += (int64_t)w[2 * 31] << (kShift - 1);  // centre tap 0.5
    acc_q += (int64_t)w[2 * 31 + 1] << (kShift - 1);
    *oi = (int32_t)(acc_i >> kShift);
    *oq = (int32_t)(acc_q >> kShift);
    return true;
  }

 private:
  static constexpr int kTaps = 63;
  int32_t buf_[2 * 2 * kTaps];
  int pos_;
  int phase_;
};

}  // namespace

int main(int argc, char** argv) {
  if (argc == 4 && std::strcmp(argv[1], "--parity") == 0) {
    // Parity mode: decimate an int16 interleaved capture with the exact
    // reference integer arithmetic and dump int32 outputs — the oracle for
    // the framework's fixed-point parity test (SURVEY.md §7.3 hard part 4).
    FILE* fi = fopen(argv[2], "rb");
    FILE* fo = fopen(argv[3], "wb");
    if (!fi || !fo) return 2;
    HalfbandDecimator st[6];
    int16_t s[2];
    while (fread(s, sizeof(int16_t), 2, fi) == 2) {
      int32_t i = s[0], q = s[1], oi, oq;
      if (!st[0].feed(i, q, &oi, &oq)) continue;
      if (!st[1].feed(oi, oq, &oi, &oq)) continue;
      if (!st[2].feed(oi, oq, &oi, &oq)) continue;
      if (!st[3].feed(oi, oq, &oi, &oq)) continue;
      if (!st[4].feed(oi, oq, &oi, &oq)) continue;
      if (!st[5].feed(oi, oq, &oi, &oq)) continue;
      int32_t o[2] = {oi, oq};
      fwrite(o, sizeof(int32_t), 2, fo);
    }
    fclose(fi);
    fclose(fo);
    return 0;
  }
  const long n = argc > 1 ? atol(argv[1]) : 1048576;
  const int repeat = argc > 2 ? atoi(argv[2]) : 10;

  std::vector<int16_t> in(2 * n);
  std::mt19937 rng(1234);
  std::uniform_int_distribution<int> dist(-2048, 2047);
  for (auto& v : in) v = (int16_t)dist(rng);
  std::vector<int32_t> out(2 * (n / 64) + 16);

  HalfbandDecimator st[6];
  // warmup
  volatile int32_t sink = 0;

  auto t0 = std::chrono::steady_clock::now();
  for (int r = 0; r < repeat; ++r) {
    size_t w = 0;
    for (long s = 0; s < n; ++s) {
      int32_t i = in[2 * s], q = in[2 * s + 1];
      int32_t oi, oq;
      if (!st[0].feed(i, q, &oi, &oq)) continue;
      if (!st[1].feed(oi, oq, &oi, &oq)) continue;
      if (!st[2].feed(oi, oq, &oi, &oq)) continue;
      if (!st[3].feed(oi, oq, &oi, &oq)) continue;
      if (!st[4].feed(oi, oq, &oi, &oq)) continue;
      if (!st[5].feed(oi, oq, &oi, &oq)) continue;
      out[w++] = oi;
      out[w++] = oq;
    }
    sink += out[0];
  }
  auto t1 = std::chrono::steady_clock::now();
  double secs = std::chrono::duration<double>(t1 - t0).count();
  // same figure of merit as mainbench.cpp:385-391: input samples per second
  double ksps = (double)n * repeat / secs / 1e3;
  printf("{\"ksps\": %.1f, \"nsamples\": %ld, \"repeat\": %d, \"secs\": %.3f}\n",
         ksps, n, repeat, secs);
  (void)sink;
  return 0;
}
