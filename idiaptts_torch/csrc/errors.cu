// Error strings for the C entry points of the kernel library: each entry
// point returns a cudaError_t as int; the Python wrapper turns a non-zero
// code into an exception carrying this text.
#include <cuda_runtime.h>

extern "C" const char* idt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
