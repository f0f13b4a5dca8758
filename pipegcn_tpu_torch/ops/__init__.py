from .spmm import csr_indptr, spmm_mean, spmm_mean_plain

__all__ = ["csr_indptr", "spmm_mean", "spmm_mean_plain"]
