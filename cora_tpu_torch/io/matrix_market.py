"""MatrixMarket I/O for the golden test fixtures (the JAX package's
`cora_tpu/io/matrix_market.py`).

The reference validates its data-matrix assembly against MATLAB-exported
`.mm` files (`tests/test_utils.cpp:24-58`); symmetric files store the
lower triangle and must be mirrored (`tests/test_utils.cpp:36-52`).
scipy's `mmread` already mirrors `symmetric`-flagged files, so this is a
thin wrapper that always returns CSR.
"""

from __future__ import annotations

import numpy as np
import scipy.io
import scipy.sparse


def read_matrix_market(path: str) -> scipy.sparse.csr_matrix:
    M = scipy.io.mmread(path)
    if scipy.sparse.issparse(M):
        return M.tocsr()
    return scipy.sparse.csr_matrix(np.asarray(M))


def read_matrix_market_dense(path: str) -> np.ndarray:
    M = scipy.io.mmread(path)
    if scipy.sparse.issparse(M):
        return M.toarray()
    return np.asarray(M)


def write_matrix_market(M, path: str) -> None:
    scipy.io.mmwrite(path, scipy.sparse.coo_matrix(M))
