// K6 / K8 (GAT attention, forward and the src-keyed backward pass) for f32 z
// and g rows (f32 compute; the bf16 logits layer): the kernels of
// gat_attn.cuh, compiled for one row-type mode a library so that the three
// builds run in parallel.
#define PGT_GAT_MODE 0
#include "gat_attn.cuh"
