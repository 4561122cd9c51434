// The launch device of the kernel library.
//
// nvcc links the CUDA runtime statically into libeal_kernels.so, so the
// library keeps a current device of its own, apart from PyTorch's. Every
// entry point sets its kernel's attributes (cudaFuncSetAttribute) and reads
// the SM count on that current device, while it launches on the stream it
// is given. The wrappers call eal_set_device with the device of their
// tensors before each launch, so the attributes, the SM count and the stream
// all belong to one device.

#include <cuda_runtime.h>

extern "C" int eal_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
