// Runs a kernel launch on the host: one block at a time, one host thread
// per CUDA thread, a barrier per block for __syncthreads and one per warp
// for the collectives.  ldmatrix, mma.sync m16n8k16 (bf16, fp32
// accumulation) and shuffles gather every lane's operands into the warp's
// exchange area and hand each lane its part of the result, in the
// fragment layouts of the PTX ISA.  cp.async copies are queued per thread
// and land when cp.async.wait_group retires their group, so a read before
// the wait sees the stale stage.
#include <atomic>
#include <chrono>
#include <barrier>
#include <condition_variable>
#include <mutex>
#include <unordered_map>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <memory>
#include <thread>
#include <vector>

#include "fake_cuda.h"
#include "cuda.h"

thread_local uint3 threadIdx;
uint3 blockIdx;
dim3 gridDim, blockDim;

namespace {

alignas(1024) unsigned char g_smem[1 << 18];

struct Warp {
  std::barrier<> bar{32};
  uint32_t x[32][8];
  const void* addr[32];
};
std::unique_ptr<std::barrier<>> g_block;
std::vector<std::unique_ptr<Warp>> g_warps;

Warp& warp() { return *g_warps[threadIdx.x / 32]; }
int lane() { return threadIdx.x & 31; }

float lo16(uint32_t u) { return __bfloat162float({uint16_t(u & 0xffff)}); }
float hi16(uint32_t u) { return __bfloat162float({uint16_t(u >> 16)}); }

struct Copy {
  void* dst;
  const void* src;
  int src_bytes, bytes;
};
thread_local std::deque<std::vector<Copy>> t_groups;
thread_local std::vector<Copy> t_open;

void land(const std::vector<Copy>& group) {
  for (const Copy& c : group) {
    memset(c.dst, 0, c.bytes);
    if (c.src_bytes) memcpy(c.dst, c.src, c.src_bytes);
  }
}

[[noreturn]] void die(const char* what) {
  fprintf(stderr, "emulated kernel fault: %s\n", what);
  abort();
}

// ---- Hopper: tensor maps, mbarriers, TMA, wgmma ----

struct Map {  // what cuTensorMapEncodeTiled keeps in the opaque block
  const unsigned char* base;
  uint64_t dims[2], stride;
  uint32_t box[2];
  int swizzle;
};
static_assert(sizeof(Map) <= sizeof(CUtensorMap), "map layout");

struct TmaCopy {
  unsigned char* dst;
  Map map;
  int c0, c1;
};

struct Bar {
  int expected = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;
  std::vector<TmaCopy> copies;
};

std::mutex g_mu;
std::condition_variable g_cv;
std::unordered_map<void*, Bar> g_bars;

Bar& bar_at(void* p) {
  auto it = g_bars.find(p);
  if (it == g_bars.end()) die("mbarrier used before mbarrier.init");
  return it->second;
}

void maybe_complete(Bar& b) {
  if (b.pending < 0 || b.tx < 0) die("mbarrier over-arrived");
  if (b.pending == 0 && b.tx == 0) {
    ++b.phase;
    b.pending = b.expected;
    g_cv.notify_all();
  }
}

// the 128-byte swizzle: bits [4, 7) of a shared-memory offset XOR bits [7, 10)
size_t sw128(size_t off) { return off ^ (((off >> 7) & 7) << 4); }

void land(Bar& b) {
  for (const TmaCopy& c : b.copies) {
    const Map& m = c.map;
    const size_t dst = c.dst - g_smem;
    for (uint32_t r = 0; r < m.box[1]; ++r)
      for (uint32_t col = 0; col < m.box[0]; ++col) {
        const size_t off = dst + size_t(r) * m.box[0] + col;
        g_smem[m.swizzle ? sw128(off) : off] =
            m.base[(c.c1 + r) * m.stride + c.c0 + col];
      }
    b.tx -= static_cast<long long>(m.box[0]) * m.box[1];
  }
  b.copies.clear();
  maybe_complete(b);
}

struct WgOp {
  int* d;
  int n;
  uint64_t da, db;
  int scale_d;
};
thread_local std::vector<WgOp> t_wg_open;
thread_local std::deque<std::vector<WgOp>> t_wg_groups;

// byte (row, k) of a K-major operand with the 128-byte swizzle
int8_t operand(uint64_t desc, int row, int k) {
  if ((desc >> 62) != 1 || ((desc >> 49) & 7) != 0)
    die("wgmma descriptor: not the 128-byte swizzle with base offset 0");
  const size_t start = (desc & 0x3fff) << 4;
  const size_t sbo = ((desc >> 32) & 0x3fff) << 4;
  const size_t off = start + (row >> 3) * sbo + (row & 7) * 128 + k;
  if (off >= sizeof(g_smem)) die("wgmma operand outside shared memory");
  return static_cast<int8_t>(g_smem[sw128(off)]);
}

// this thread's part of d[64 x n] (+)= A[64 x 32] . B[n x 32]^T
void run_wgmma(const WgOp& op) {
  const int tid = threadIdx.x & 127;
  const int w = tid >> 5, l = tid & 31, g = l >> 2, t = l & 3;
  for (int j = 0; j < op.n / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * w + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
      int sum = op.scale_d ? op.d[4 * j + e] : 0;
      for (int k = 0; k < 32; ++k)
        sum += int(operand(op.da, row, k)) * int(operand(op.db, col, k));
      op.d[4 * j + e] = sum;
    }
}

}  // namespace

unsigned char* emu_smem() { return g_smem; }

uint32_t emu_smem_offset(const void* p) {
  const auto* c = static_cast<const unsigned char*>(p);
  if (c < g_smem || c >= g_smem + sizeof(g_smem))
    die("a shared-memory address outside the block's shared memory");
  return static_cast<uint32_t>(c - g_smem);
}

static CUresult emu_encode_tiled(CUtensorMap* out, CUtensorMapDataType, cuuint32_t rank,
                                 void* base, const cuuint64_t* dims,
                                 const cuuint64_t* strides, const cuuint32_t* box,
                                 const cuuint32_t* unit, CUtensorMapInterleave,
                                 CUtensorMapSwizzle swizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill) {
  if (rank != 2 || reinterpret_cast<uintptr_t>(base) % 16 || strides[0] % 16 ||
      box[0] > 256 || box[1] > 256 || box[0] % 16 || unit[0] != 1 || unit[1] != 1)
    return CUDA_ERROR_INVALID_VALUE;
  if (swizzle != CU_TENSOR_MAP_SWIZZLE_NONE &&
      (swizzle != CU_TENSOR_MAP_SWIZZLE_128B || box[0] > 128))
    return CUDA_ERROR_INVALID_VALUE;
  Map m{static_cast<const unsigned char*>(base), {dims[0], dims[1]}, strides[0],
        {box[0], box[1]}, swizzle == CU_TENSOR_MAP_SWIZZLE_128B};
  memset(out, 0, sizeof(*out));
  memcpy(out, &m, sizeof(m));
  return CUDA_SUCCESS;
}

cudaError_t cudaGetDriverEntryPointByVersion(const char* name, void** fn,
                                             unsigned, unsigned long long,
                                             cudaDriverEntryPointQueryResult* q) {
  const bool ok = strcmp(name, "cuTensorMapEncodeTiled") == 0;
  *fn = ok ? reinterpret_cast<void*>(&emu_encode_tiled) : nullptr;
  *q = ok ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
  return cudaSuccess;
}

void emu_mbar_init(void* bar, int count) {
  std::lock_guard<std::mutex> lk(g_mu);
  Bar& b = g_bars[bar];
  b = Bar{};
  b.expected = b.pending = count;
}

// mbarrier.arrive, with expect-tx of tx_bytes first (arrive.expect_tx)
void emu_mbar_arrive(void* bar, uint32_t tx_bytes) {
  std::lock_guard<std::mutex> lk(g_mu);
  Bar& b = bar_at(bar);
  b.tx += tx_bytes;
  --b.pending;
  maybe_complete(b);
}

// try_wait.parity in a loop: done once the phase of that parity completed;
// the waiter lands the barrier's queued TMA copies
void emu_mbar_wait(void* bar, uint32_t parity) {
  std::unique_lock<std::mutex> lk(g_mu);
  for (;;) {
    Bar& b = bar_at(bar);
    if ((b.phase & 1) != (parity & 1)) return;
    if (!b.copies.empty()) {
      land(b);
      continue;
    }
    if (g_cv.wait_for(lk, std::chrono::seconds(20)) == std::cv_status::timeout) {
      fprintf(stderr, "thread %u of block %u waits 20 s for parity %u of the "
              "mbarrier at shared offset %zu (phase %u, %d arrivals and %lld "
              "bytes pending)\n", threadIdx.x, blockIdx.x, parity,
              static_cast<size_t>(static_cast<unsigned char*>(bar) - g_smem),
              b.phase, b.pending, b.tx);
      die("deadlock");
    }
  }
}

void emu_tma_load_2d(void* dst, const void* map, void* bar, int c0, int c1) {
  std::lock_guard<std::mutex> lk(g_mu);
  Map m;
  memcpy(&m, map, sizeof(m));
  const size_t off = emu_smem_offset(dst);
  if (off % (m.swizzle ? 1024 : 128))
    die("TMA destination misaligned for its swizzle");
  if (c0 < 0 || c1 < 0 || c0 + m.box[0] > m.dims[0] || c1 + m.box[1] > m.dims[1])
    die("TMA box out of bounds");
  if (off + size_t(m.box[0]) * m.box[1] > sizeof(g_smem))
    die("TMA box past the end of shared memory");
  bar_at(bar).copies.push_back({static_cast<unsigned char*>(dst), m, c0, c1});
  g_cv.notify_all();
}

void emu_wgmma_s8(int* d, int n, uint64_t da, uint64_t db, int scale_d) {
  t_wg_open.push_back({d, n, da, db, scale_d});
}

void emu_wgmma_commit() {
  t_wg_groups.push_back(t_wg_open);
  t_wg_open.clear();
}

void emu_wgmma_wait(int pending) {
  while (static_cast<int>(t_wg_groups.size()) > pending) {
    for (const WgOp& op : t_wg_groups.front()) run_wgmma(op);
    t_wg_groups.pop_front();
  }
}

void __syncthreads() { g_block->arrive_and_wait(); }

// a barrier that also returns whether any thread's pred is nonzero
int __syncthreads_or(int pred) {
  static std::atomic<int> any{0};
  g_block->arrive_and_wait();
  if (pred) any.store(1);
  g_block->arrive_and_wait();
  const int r = any.load();
  g_block->arrive_and_wait();
  if (threadIdx.x == 0) any.store(0);
  return r;
}

void __syncwarp() { warp().bar.arrive_and_wait(); }

int __any_sync(unsigned, int pred) {
  Warp& w = warp();
  w.x[lane()][7] = pred != 0;
  w.bar.arrive_and_wait();
  int r = 0;
  for (int l = 0; l < 32; ++l) r |= w.x[l][7];
  w.bar.arrive_and_wait();
  return r;
}

// ex2.approx.ftz.f32: results below the smallest normal float flush to 0
float emu_ex2(float x) {
  const float y = exp2f(x);
  return y < 1.17549435e-38f ? 0.f : y;
}

unsigned emu_shfl(unsigned bits, int lane_mask) {
  Warp& w = warp();
  const int l = lane();
  w.x[l][6] = bits;
  w.bar.arrive_and_wait();
  const unsigned r = w.x[l ^ lane_mask][6];
  w.bar.arrive_and_wait();
  return r;
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the rows of matrix i
void emu_ldsm(uint32_t (&r)[4], const void* row, bool trans) {
  Warp& w = warp();
  const int l = lane();
  w.addr[l] = row;
  w.bar.arrive_and_wait();
  for (int mi = 0; mi < 4; ++mi) {
    uint16_t lo, hi;
    if (!trans) {
      const auto* p = static_cast<const uint16_t*>(w.addr[8 * mi + l / 4]);
      lo = p[2 * (l % 4)];
      hi = p[2 * (l % 4) + 1];
    } else {
      const auto* a = static_cast<const uint16_t*>(w.addr[8 * mi + 2 * (l % 4)]);
      const auto* b =
          static_cast<const uint16_t*>(w.addr[8 * mi + 2 * (l % 4) + 1]);
      lo = a[l / 4];
      hi = b[l / 4];
    }
    r[mi] = uint32_t(lo) | (uint32_t(hi) << 16);
  }
  w.bar.arrive_and_wait();
}

// c[16 x 8] += a[16 x 16] . b[16 x 8]; lane 4g + t holds a's rows g, g + 8
// at columns 2t, 2t + 1 (and + 8), b's column g at rows 2t, 2t + 1 (and
// + 8), c's rows g, g + 8 at columns 2t, 2t + 1
void emu_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
             uint32_t b1) {
  Warp& w = warp();
  const int l = lane();
  for (int i = 0; i < 4; ++i) w.x[l][i] = a[i];
  w.x[l][4] = b0;
  w.x[l][5] = b1;
  w.bar.arrive_and_wait();
  float A[16][16], B[16][8];
  for (int s = 0; s < 32; ++s) {
    const int g = s / 4, t = s % 4;
    const uint32_t* x = w.x[s];
    A[g][2 * t] = lo16(x[0]);
    A[g][2 * t + 1] = hi16(x[0]);
    A[g + 8][2 * t] = lo16(x[1]);
    A[g + 8][2 * t + 1] = hi16(x[1]);
    A[g][2 * t + 8] = lo16(x[2]);
    A[g][2 * t + 9] = hi16(x[2]);
    A[g + 8][2 * t + 8] = lo16(x[3]);
    A[g + 8][2 * t + 9] = hi16(x[3]);
    B[2 * t][g] = lo16(x[4]);
    B[2 * t + 1][g] = hi16(x[4]);
    B[2 * t + 8][g] = lo16(x[5]);
    B[2 * t + 9][g] = hi16(x[5]);
  }
  w.bar.arrive_and_wait();
  const int g = l / 4, t = l % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    double sum = c[e];
    for (int k = 0; k < 16; ++k) sum += double(A[row][k]) * double(B[k][col]);
    c[e] = float(sum);
  }
}

void emu_cp_async(void* dst, const void* src, int src_bytes, int bytes) {
  t_open.push_back({dst, src, src_bytes, bytes});
}

void emu_commit() {
  t_groups.push_back(t_open);
  t_open.clear();
}

void emu_wait(int pending) {
  while (static_cast<int>(t_groups.size()) > pending) {
    land(t_groups.front());
    t_groups.pop_front();
  }
}

void emu_launch(dim3 grid, int threads, std::function<void()> body) {
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        memset(g_smem, 0xcd, sizeof(g_smem));  // stale, as on the card
        g_block = std::make_unique<std::barrier<>>(threads);
        g_warps.clear();
        {
          std::lock_guard<std::mutex> lk(g_mu);
          g_bars.clear();
        }
        for (int i = 0; i < threads / 32; ++i)
          g_warps.push_back(std::make_unique<Warp>());
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([&, t] {
            threadIdx = {unsigned(t), 0, 0};
            t_groups.clear();
            t_open.clear();
            t_wg_groups.clear();
            t_wg_open.clear();
            body();
            if (!t_groups.empty() || !t_open.empty()) {
              fprintf(stderr, "a thread ended with cp.async copies pending\n");
              abort();
            }
            if (!t_wg_groups.empty() || !t_wg_open.empty()) {
              fprintf(stderr, "a thread ended with wgmma groups pending\n");
              abort();
            }
          });
        for (auto& th : ts) th.join();
      }
}
