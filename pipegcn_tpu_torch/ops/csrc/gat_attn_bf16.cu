// K6 / K8 (GAT attention, forward and the src-keyed backward pass) for bf16
// z and g rows (bf16 compute; --rem-dtype bfloat16): the kernels of
// gat_attn.cuh, compiled for one row-type mode a library so that the three
// builds run in parallel.
#define PGT_GAT_MODE 1
#include "gat_attn.cuh"
