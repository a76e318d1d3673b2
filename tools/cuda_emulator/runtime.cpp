// Runs a kernel launch on the host: one block at a time, one host thread
// per CUDA thread, a barrier per block for __syncthreads and one per warp
// for the collectives.  ldmatrix, mma.sync m16n8k16 (bf16, fp32
// accumulation) and shuffles gather every lane's operands into the warp's
// exchange area and hand each lane its part of the result, in the
// fragment layouts of the PTX ISA.  cp.async copies are queued per thread
// and land when cp.async.wait_group retires their group, so a read before
// the wait sees the stale stage.
#include <atomic>
#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <memory>
#include <thread>
#include <vector>

#include "fake_cuda.h"

thread_local uint3 threadIdx;
uint3 blockIdx;
dim3 gridDim, blockDim;

namespace {

alignas(128) unsigned char g_smem[1 << 18];

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

}  // namespace

unsigned char* emu_smem() { return g_smem; }

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
        for (int i = 0; i < threads / 32; ++i)
          g_warps.push_back(std::make_unique<Warp>());
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([&, t] {
            threadIdx = {unsigned(t), 0, 0};
            t_groups.clear();
            t_open.clear();
            body();
            if (!t_groups.empty() || !t_open.empty()) {
              fprintf(stderr, "a thread ended with cp.async copies pending\n");
              abort();
            }
          });
        for (auto& th : ts) th.join();
      }
}
