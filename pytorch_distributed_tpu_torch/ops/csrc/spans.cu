// Span marks: device timestamps that survive a CUDA graph capture.
//
// Replaces no TPU kernel. A captured train step (pipeline_exec/runner.py)
// keeps none of its host-side regions at replay: record_function ranges and
// NVTX run once, at capture. A mark is a kernel, so a capture records it as
// a graph node and every replay runs it, in stream order with the work
// around it:
//   ptd_span_<name>_begin stores %globaltimer (ns) into the span's slot;
//   ptd_span_<name>_end adds (now - slot) / 1e6 to the span's fp32
//     accumulator, so a span may open and close many times a step.
// The symbol names the span, so a device trace identifies each boundary by
// itself (portbench/spans.py pairs them); the accumulators are the program's
// own reading of the same boundaries, with no profiler
// (observability/spans.py, read into the runner's metric ring).
//
// What bounds it: launch latency. One block of one thread, one 8-byte load
// or store; each mark is ~1-2 us of a graph's node overhead, nothing else.
//
// PTD_SPANS is the one list of span names; observability/spans.py keeps the
// same list, in the same order (a CPU test holds the two equal).
#include <cuda_runtime.h>
#include <stdint.h>

#define PTD_SPANS(X) \
  X(forward)         \
  X(backward)        \
  X(grad_exchange)   \
  X(update)          \
  X(lm_head)         \
  X(lm_loss)         \
  X(bn_group)

namespace {

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

}  // namespace

#define PTD_SPAN_KERNELS(name)                                                 \
  extern "C" __global__ void ptd_span_##name##_begin(unsigned long long* t0) { \
    *t0 = globaltimer();                                                       \
  }                                                                            \
  extern "C" __global__ void ptd_span_##name##_end(                            \
      const unsigned long long* t0, float* acc) {                              \
    *acc += static_cast<float>(globaltimer() - *t0) * 1e-6f;                   \
  }
PTD_SPANS(PTD_SPAN_KERNELS)

typedef void (*BeginKernel)(unsigned long long*);
typedef void (*EndKernel)(const unsigned long long*, float*);

#define PTD_BEGIN_ENTRY(name) ptd_span_##name##_begin,
#define PTD_END_ENTRY(name) ptd_span_##name##_end,
static const BeginKernel kBegin[] = {PTD_SPANS(PTD_BEGIN_ENTRY)};
static const EndKernel kEnd[] = {PTD_SPANS(PTD_END_ENTRY)};
static const int kSpans = sizeof(kBegin) / sizeof(kBegin[0]);

extern "C" int ptd_span_count() { return kSpans; }

// Mark span `index` on `stream`: its begin (end == 0) or its end. `t0` and
// `acc` are the bases of the per-span slots ([kSpans] of u64 and of fp32).
// Returns the launch's cudaError_t.
extern "C" int ptd_span_mark(int index, int end, void* t0, void* acc,
                             void* stream) {
  if (index < 0 || index >= kSpans) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned long long* slot = static_cast<unsigned long long*>(t0) + index;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (end) {
    kEnd[index]<<<1, 1, 0, s>>>(slot, static_cast<float*>(acc) + index);
  } else {
    kBegin[index]<<<1, 1, 0, s>>>(slot);
  }
  return static_cast<int>(cudaGetLastError());
}
