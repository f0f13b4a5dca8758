// K6 / K8 (GAT attention, forward and the src-keyed backward pass) for e4m3
// z rows and e5m2 g rows (--rem-dtype float8): the kernels of gat_attn.cuh,
// compiled for one row-type mode a library so that the three builds run in
// parallel.
#define PGT_GAT_MODE 2
#include "gat_attn.cuh"
