// Error reporting for the Python wrappers: the text of a cudaError_t
// returned by one of the C entry points.
#include <cuda_runtime.h>

extern "C" const char* cmst_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
