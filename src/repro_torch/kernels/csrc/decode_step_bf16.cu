// The bfloat16 half of the decode kernels (decode_step.cuh).
#include <cuda_bf16.h>
#define DECODE_STEP_T __nv_bfloat16
#define DECODE_STEP_DTYPE 1
#include "decode_step.cuh"
