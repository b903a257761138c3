// Phase marks: one empty kernel for each phase of the training step, so
// that a device trace can be divided by phase.
//
// Replaces no TPU kernel. A CUDA graph replays the step's kernels with no
// host code between them, so a span opened on the host at capture time
// never reaches a replay; a kernel launched at a phase's start is captured
// like any other and runs in every replay, where its start in the trace
// marks the phase's first device record. utils/profiling.py::phase
// launches one on the current stream as a phase opens on the card.
//
// Bound: launch latency alone (one block of one thread, no memory touched),
// a few microseconds a mark.
//
// PHASE_MARK(name) defines the kernel tg_phase_<name>, extern "C" so that a
// trace shows its name as written, and its launcher
// tg_phase_<name>_mark(stream), which utils/profiling.py looks up by name.
//
// Plain C interface, loaded with ctypes; a launcher launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#define PHASE_MARK(name)                                               \
  extern "C" __global__ void tg_phase_##name() {}                      \
  extern "C" int tg_phase_##name##_mark(void* stream) {                \
    tg_phase_##name<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(); \
    return (int)cudaGetLastError();                                    \
  }

PHASE_MARK(sn)
PHASE_MARK(d_reg)
PHASE_MARK(d_grad)
PHASE_MARK(d_adam)
PHASE_MARK(g_grad)
PHASE_MARK(g_adam)
PHASE_MARK(c_grad)
PHASE_MARK(c_adam)
PHASE_MARK(end)
