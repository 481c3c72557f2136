// Hopper (sm_90a) primitives as thin wrappers over PTX: mbarriers, bulk
// asynchronous copies (1-D and through a TMA tensor map), warpgroup matrix
// products (wgmma) and their shared-memory descriptors, and on the host the
// tensor maps themselves.  Used by the encoder attention kernel
// (attention.cu), the tiled product (gemm_sm90.cuh), the split
// cross-attention steps (cross_attention.cu, and cross_attention.cuh's
// cluster, which also uses the cluster barrier and mma.sync) and the
// self-attention step (self_attention.cu), the int8 verify pass
// (cross_attention.cuh's cross_int8_cluster: int8 mma.sync, additions into
// another block's shared memory), the decoder MLP (decoder_mlp.cu:
// cp.async, ldmatrix, programmatic dependent launch) and the fused
// attention blocks (decoder_block.cuh and the two decoder_*_block.cu: fp64
// mma.sync as well).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; nothing of libcuda is linked

#include "common.cuh"

#define WT_DEV __device__ __forceinline__

WT_DEV uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------
// A barrier counts thread arrivals and, for asynchronous copies, bytes.  A
// wait names the parity of the phase it waits for: a fresh barrier is in
// phase 0 (incomplete), and a wait on parity 1 returns at once.

WT_DEV void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

// After the inits, before any other thread or the copy engine uses them.
WT_DEV void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

WT_DEV void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// One arrival that also announces `bytes` of asynchronous copies.
WT_DEV void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

WT_DEV void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's earlier accesses to shared memory before later
// asynchronous copies into it (a buffer that is filled again).
WT_DEV void async_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- bulk asynchronous copies ----------------------------------------------

// `bytes` contiguous bytes from device to shared memory; both addresses and
// the size are multiples of 16.  Completion is counted on `bar`.
WT_DEV void bulk_load_1d(uint32_t dst, const void* src, uint32_t bytes,
                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One box of a 3-D tensor map (coordinates innermost first).  Elements
// outside the tensor arrive as zeros and count as bytes all the same.
WT_DEV void tma_load_3d(uint32_t dst, const void* map, uint32_t bar, int c0,
                        int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 2-D tensor map (coordinates innermost first).
WT_DEV void tma_load_2d(uint32_t dst, const void* map, uint32_t bar, int c0,
                        int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- cluster barrier --------------------------------------------------------
// Every thread of every block of the cluster arrives, then waits; a block
// that has arrived and does not wait may leave.  `arrive` releases this
// thread's earlier writes (to its own or another block's shared memory) to
// the threads that `wait` acquires; `arrive_relaxed` only says that the
// block is running, which a block must know of another before it writes
// into that one's shared memory.

WT_DEV void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

WT_DEV void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

WT_DEV void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// ---- distributed shared memory -------------------------------------------
// The address of the same shared variable in block `rank` of the cluster,
// and an int32 addition into it (exact, so the order of a cluster's
// additions does not show in the sum).

WT_DEV uint32_t dsmem_map(uint32_t saddr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(saddr), "r"(rank));
  return r;
}

WT_DEV void dsmem_add(uint32_t addr, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.s32 [%0], %1;"
               ::"r"(addr), "r"(v)
               : "memory");
}

// ---- cp.async (16 bytes a thread) and programmatic dependent launch --------

WT_DEV void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
               : "memory");
}

// Closes this thread's copies issued so far into a group; a wait for N
// lets the N most recent groups still be in flight.
WT_DEV void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
WT_DEV void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The dependent grid of a launch with programmatic stream serialization may
// start: its blocks run what precedes their grid_dependency_wait.
WT_DEV void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Waits until the grid this one depends on has finished and its writes are
// visible (at once without such a dependency).
WT_DEV void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ---- mma.sync ---------------------------------------------------------------

// d[16 x 8] = A[16 x 16] . B[16 x 8] + c, bf16 -> fp32, by one warp, every
// operand in registers, a word two bf16 with the lower depth in the low half
// (PTX's m16n8k16 fragments: lane = 4 g + t holds A's row g at depths 2t,
// 2t + 1 (a0) and 2t + 8, 2t + 9 (a2), row g + 8 at the same depths (a1,
// a3), B's column g at depths 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1), and
// d's row g (d0, d1) and row g + 8 (d2, d3) at columns 2t, 2t + 1).
WT_DEV void mma_m16n8k16_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                              uint32_t a2, uint32_t a3, uint32_t b0,
                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d[8 x 8] += A[8 x 4] . B[4 x 8] in fp64 on the fp64 tensor cores (DMMA),
// by one warp (PTX's m8n8k4 .f64 fragments: lane = 4 g + t holds A's row g
// at depth t (a), B's column g at depth t (b), and d's row g at columns 2t,
// 2t + 1).
WT_DEV void mma_m8n8k4_f64(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// d[16 x 8] += A[16 x 32] . B[32 x 8], int8 -> int32 (exact), by one warp
// (PTX's m16n8k32 fragments: lane = 4 g + t holds four bytes of A's row g at
// depths 4t .. 4t + 3 (a0) and 16 + 4t .. (a2), row g + 8 likewise (a1, a3),
// B's column g at depths 4t .. (b0) and 16 + 4t .. (b1), and d's row g (d0,
// d1) and row g + 8 (d2, d3) at columns 2t, 2t + 1).
WT_DEV void mma_m16n8k32_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                            uint32_t a2, uint32_t a3, uint32_t b0,
                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit values from shared memory, lanes 8 i .. 8 i
// + 7 giving the rows of matrix i: as A's m16n8k16 fragment (a0..a3), or,
// transposed, as two columns' B fragments (b0, b1 of each).
WT_DEV void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

WT_DEV void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A warp's part of A[16 x K] . W[K x 16], bf16 -> fp32: A's rows [16][lda]
// and W's rows [K][ldw] in shared memory (rows on 16-byte boundaries), over
// depths [k0, k0 + kn), kn a multiple of 16, by ldmatrix and mma.sync
// m16n8k16; d[nt] is the accumulator of columns 8 nt .. 8 nt + 7 (rows g
// and g + 8 as mma_m16n8k16_bf16 holds them), summed from 0 in depth order.
WT_DEV void mma_tile_16x16(const bf16* sA, int lda, const bf16* sW, int ldw,
                           int k0, int kn, float (&d)[2][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[nt][e] = 0.0f;
  const uint32_t a_addr =
      smem_u32(sA + (lane % 16) * lda + k0 + 8 * (lane / 16));
  const uint32_t w_addr = smem_u32(
      sW + (k0 + 8 * ((lane / 8) % 2) + lane % 8) * ldw + 8 * (lane / 16));
  for (int k = 0; k < kn; k += 16) {
    uint32_t a[4], w[4];
    ldmatrix_x4(a, a_addr + 2 * k);
    ldmatrix_x4_trans(w, w_addr + 2 * k * ldw);
    mma_m16n8k16_bf16(d[0], a[0], a[1], a[2], a[3], w[0], w[1]);
    mma_m16n8k16_bf16(d[1], a[0], a[1], a[2], a[3], w[2], w[3]);
  }
}

// ---- wgmma ----------------------------------------------------------------

// Descriptor of a bf16 operand tile in shared memory whose rows are 128
// bytes (64 values), written with the 128-byte swizzle, base 1024-aligned:
// eight rows make a 1024-byte group (the stride offset).  It serves a
// K-major operand (Q, K: the product's depth runs along the row) and an
// MN-major one (V, a weight [K, N]: the depth runs across rows) alike; which
// it is, the instruction's transpose bit says.  An MN-major operand wider
// than 64 values is several such tiles, `lead_bytes` apart (the leading
// offset); a K-major operand and one of 64 values do not use it.
WT_DEV uint64_t wgmma_desc(uint32_t saddr, uint32_t lead_bytes = 16) {
  uint64_t d = 0;
  d |= (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)(lead_bytes >> 4) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;  // 128-byte swizzle
  return d;
}

WT_DEV void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
WT_DEV void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
WT_DEV void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d[64 x 128] (+)= A[64 x 16] . B, bf16 -> fp32; A and B from shared
// memory, A K-major; B K-major ([128 x 16], TRANS_B = 0) or MN-major
// ([16 x 128]: 16 rows of two 64-value tiles, TRANS_B = 1).  `acc` = 0
// overwrites d.
template <int TRANS_B = 0>
WT_DEV void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TRANS_B)
      : "memory");
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], bf16 -> fp32; A from registers
// (the m64k16 fragment: four words of two bf16), B from shared memory,
// MN-major (its 16 depth rows are 16 rows of the tile).
WT_DEV void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                               uint32_t a2, uint32_t a3, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc)
      : "memory");
}

// After a wait: keeps the compiler from reading accumulator registers above
// the wait that makes them valid.
template <int N>
WT_DEV void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A warpgroup gives up (producer) or takes (consumer) registers; all four
// warps execute it, in a branch that never rejoins the other role's.
template <int N>
WT_DEV void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
WT_DEV void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// 2^x in one instruction (ex2.approx, about 2 ulp; -inf gives +0).
WT_DEV float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 as one word of two bf16 (round to nearest even), `lo` in the low
// half.
WT_DEV uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- tensor maps (host) -----------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, found through the CUDA runtime; null where
// libcuda has none.
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult st = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &st);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                             cudaEnableDefault, &st);
#endif
    if (rc != cudaSuccess || st != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 tensor of `rank` dimensions (innermost first; `strides` in bytes,
// from the second dimension on) in boxes of `box`, 128-byte swizzle, so the
// innermost box extent is 64 values; what lies outside the tensor is filled
// with zeros.
inline bool make_tensor_map(CUtensorMap* map, const void* ptr, int rank,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box) {
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return tensor_map_encoder()(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
