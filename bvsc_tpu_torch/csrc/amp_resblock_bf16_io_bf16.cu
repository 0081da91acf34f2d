// K1-bf16 (amp_resblock_bf16.cu) with bf16 activations in and out, the
// entry point amp_resblock_bf16_io_bf16: the same source, built as a library
// of its own so that nvcc compiles it beside the float32-I/O one (one
// process a source file, ops/_build.py).
#define AMP_RESBLOCK_IO_BF16
#include "amp_resblock_bf16.cu"
