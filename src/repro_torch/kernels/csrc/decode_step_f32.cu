// The float32 half of the decode kernels (decode_step.cuh).
#define DECODE_STEP_T float
#define DECODE_STEP_DTYPE 0
#include "decode_step.cuh"
