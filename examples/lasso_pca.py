"""Sparse regression + dimensionality reduction on the default device.

Demonstrates the model families beyond the reference's zoo: Lasso
(fused ADMM, exact sparsity), ElasticNet, and PCA on the distributed
tall-skinny SVD. Run: ``python examples/lasso_pca.py``.
"""

import numpy as np

import nums_tpu
import nums_tpu.numpy as nps
from nums_tpu.models.glms import Lasso, ElasticNet
from nums_tpu.models.decomposition import PCA

nums_tpu.init()

rs = np.random.RandomState(0)
n, d = 100_000, 64
theta = np.zeros(d)
theta[[3, 17, 42]] = [2.5, -1.5, 3.0]  # 3 relevant features of 64
X = nps.array(rs.randn(n, d).astype(np.float32))
y = X @ nps.array(theta.astype(np.float32))
y = y + 0.01 * nps.random.randn(n).astype(np.float32)

# alpha uses sklearn's convention (1/(2n) residual scaling): 50/n on
# the old raw-lambda scale.
lasso = Lasso(alpha=5e-4, tol=1e-5, max_iter=500).fit(X, y)
beta = lasso._beta.get()
print("lasso support:", np.flatnonzero(np.abs(beta) > 1e-8).tolist())
print("lasso R^2:", round(float(lasso.score(X, y)), 4))

enet = ElasticNet(alpha=5e-4, l1_ratio=0.9, tol=1e-5, max_iter=500).fit(X, y)
print("elastic-net support:",
      np.flatnonzero(np.abs(enet._beta.get()) > 1e-8).tolist())

pca = PCA(n_components=8).fit(X)
print("PCA explained variance ratio (top 8):",
      np.round(pca.explained_variance_ratio_.get(), 4).tolist())
Z = pca.transform(X)
print("projected shape:", Z.shape)
