from .matrices import (LinearSystem, generate_dense_set, generate_sparse_set,
                       pad_batch, pad_system, randsvd_dense, sparse_spd)

__all__ = ["LinearSystem", "generate_dense_set", "generate_sparse_set",
           "pad_batch", "pad_system", "randsvd_dense", "sparse_spd"]
