// The anti-aliased activation (antialias_act.cu) with bf16 activations in
// and out, the entry point antialias_act_f32_io_bf16: the same source,
// built as a library of its own so that a float32 caller never compiles it
// (one library a source file, ops/_build.py).
#define ANTIALIAS_ACT_IO_BF16
#include "antialias_act.cu"
