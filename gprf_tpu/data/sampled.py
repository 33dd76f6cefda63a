"""Synthetic experiment data container with priors, metrics, and caching.

Rebuild of the reference ``SampledData`` (``gprfopt.py:19-201``) and
``sample_data`` (``gprfopt.py:204-225``): holds true latents SX, GP-prior
outputs SY, noise-corrupted observed locations X_obs, held-out test split,
the partition (grid centers or RPC with replayable splits), the isotropic
Gaussian prior on X, error metrics, and block-predictive scoring
(SMSE / MSLL vs a mean/std baseline).  Datasets cache to disk keyed by their
generation parameters, as in the reference.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from gprf_tpu.data.synthetic import sample_synthetic
from gprf_tpu.kernels.gpcov import GPCov
from gprf_tpu.model.gprf import GPRF
from gprf_tpu.partition.grid import Blocker
from gprf_tpu.partition.rpc import cluster_rpc
from gprf_tpu.utils.io import mkdir_p


def exp_base_dir() -> str:
    return os.environ.get(
        "GPRF_EXPERIMENTS", os.path.join(os.path.expanduser("~"), "gprf_experiments")
    )


class SampledData:
    def __init__(
        self,
        noise_var=0.01,
        n=30,
        ntrain=20,
        lscale=0.5,
        obs_std=0.05,
        yd=10,
        seed=1,
    ):
        self.noise_var = noise_var
        self.n = n
        self.ntrain = ntrain
        self.lscale = lscale

        Xfull, Yfull, cov = sample_synthetic(
            n=n, noise_var=noise_var, yd=yd, lscale=lscale, seed=seed
        )
        self.cov = cov
        X, Y = Xfull[:ntrain, :], Yfull[:ntrain, :]
        self.Xtest, self.Ytest = Xfull[ntrain:, :], Yfull[ntrain:, :]

        self.SX, self.SY = X, Y
        self.block_idxs = None

        self.obs_std = obs_std
        np.random.seed(seed)
        self.X_obs = self.SX + np.random.randn(*X.shape) * obs_std

    # ----- partitioning ----------------------------------------------------

    def set_centers(self, centers):
        self.centers = np.asarray(centers)
        b = Blocker(self.centers)
        self.block_idxs = b.block_clusters(self.X_obs)
        self.reblock = lambda X: b.block_clusters(X)
        self.neighbors = b.neighbors(diag_connections=True)

    def cluster_rpc(self, blocksize):
        all_idxs = np.arange(self.ntrain)
        cluster_idxs, splits = cluster_rpc(self.X_obs, all_idxs, target_size=blocksize)
        self.block_idxs = cluster_idxs
        self.rpc_splits = splits  # kept for the device engine's split replay
        self.reblock = lambda X: cluster_rpc(
            X, all_idxs, target_size=blocksize, fixed_split=splits
        )[0]
        self.neighbors = None

    def build_gprf(self, X=None, cov=None, local_dist=1e-4):
        """GPRF over the current partition (reference ``gprfopt.py:55-74``).

        ``cov`` may be a reference-style [[nv, sv, l...]] row or None for the
        generating covariance; ``local_dist`` is the neighbor threshold
        (1.0 => local GPs)."""
        if X is None:
            X = self.X_obs
        if cov is None:
            cov_obj = self.cov
            noise_var = self.noise_var
        else:
            cov = np.asarray(cov)
            if cov.shape[0] == 1:
                noise_var = cov[0, 0]
                cov_obj = GPCov.create(
                    [cov[0, 1]], cov[0, 2:], "euclidean", "se"
                )
            else:
                raise ValueError(f"invalid cov params {cov}")
        return GPRF(
            X,
            Y=self.SY,
            block_fn=self.reblock,
            block_idxs=self.block_idxs,
            cov=cov_obj,
            noise_var=noise_var,
            kernelized=False,
            neighbor_threshold=local_dist,
            neighbors=self.neighbors if local_dist < 1.0 else [],
        )

    # ----- error metrics (reference gprfopt.py:76-93) ----------------------

    def mean_distance(self, x):
        X = x.reshape(self.SX.shape)
        return float(np.mean(np.linalg.norm(X - self.SX, axis=1)))

    def mean_abs_err(self, x):
        return float(np.mean(np.abs(x - self.SX.flatten())))

    def median_abs_err(self, x):
        X = x.reshape(self.SX.shape)
        return float(np.median(np.sqrt(np.sum((X - self.SX) ** 2, axis=1))))

    def lscale_error(self, FC):
        true_lscale = float(np.asarray(self.cov.dfn_params)[0])
        return float(FC[0, 2]) / true_lscale

    # ----- priors ----------------------------------------------------------

    def x_prior(self, xx):
        """Isotropic Gaussian prior ll + gradient on flattened X
        (reference ``gprfopt.py:172-182``)."""
        xx = np.asarray(xx)
        flatobs = self.X_obs.flatten()
        n = len(xx)
        r = (xx - flatobs) / self.obs_std
        ll = -0.5 * np.sum(r**2) - 0.5 * n * np.log(2 * np.pi * self.obs_std**2)
        lderiv = -(xx - flatobs) / (self.obs_std**2)
        return ll, lderiv

    def x_prior_block(self, i, xx):
        """Gaussian X-prior restricted to block i's points
        (reference ``gprfopt.py:184-195``)."""
        xx = np.asarray(xx)
        idxs = self.block_idxs[i]
        flatobs = self.X_obs[idxs].flatten()
        n = len(xx)
        r = (xx - flatobs) / self.obs_std
        ll = -0.5 * np.sum(r**2) - 0.5 * n * np.log(2 * np.pi * self.obs_std**2)
        lderiv = -(xx - flatobs) / (self.obs_std**2)
        return ll, lderiv

    def random_init(self, jitter_std=None):
        if jitter_std is None:
            jitter_std = self.obs_std
        return self.X_obs + np.random.randn(*self.X_obs.shape) * jitter_std

    # ----- predictive scoring (reference gprfopt.py:95-170) ----------------

    def prediction_error_gp(self, x):
        """Exact-GP test log-likelihood at latents x
        (reference ``gprfopt.py:95-118``)."""
        from gprf_tpu.model.fullgp import GP

        XX = np.asarray(x).reshape(self.X_obs.shape)
        ntest = self.n - self.ntrain
        ll = 0.0
        gp = GP(X=XX, y=self.SY[:, 0:1], cov_main=self.cov, noise_var=self.noise_var)
        pred_cov = gp.covariance(self.Xtest, include_obs=True)
        _, logdet = np.linalg.slogdet(pred_cov)
        pred_prec = np.linalg.inv(pred_cov)
        for y, yt in zip(self.SY.T, self.Ytest.T):
            gp.y = y.reshape(-1, 1)
            gp.alpha_r = gp.factor(y)
            pred_means = gp.predict(self.Xtest)
            rt = yt - pred_means
            lly = -0.5 * rt @ (pred_prec @ rt)
            lly += -0.5 * logdet
            lly += -0.5 * ntest * np.log(2 * np.pi)
            ll += lly
        return float(ll)

    def prediction_error(self, X=None, cov=None, local_dist=1.0):
        """(SMSE, MSLL_block, MSLL_diag) of the BCM predictor on the test
        split vs the mean/std baseline (reference ``gprfopt.py:121-170``)."""
        gprf = self.build_gprf(X=X, cov=cov, local_dist=local_dist)
        test_blocks = self.reblock(self.Xtest)
        # one device dispatch answers every test block (predict.py:
        # train_block_predictor); the per-call predictor costs a dispatch
        # and a host round trip per block
        from gprf_tpu.model.predict import train_block_predictor

        predict_blocks = train_block_predictor(gprf)
        results = predict_blocks(
            test_blocks, self.Xtest, test_noise_var=self.noise_var
        )

        def gaussian_ll(Y, M, C):
            ntest, yd = Y.shape
            P = np.linalg.inv(C)
            R = Y - M
            ll = -0.5 * np.sum(P * (R @ R.T))
            ll -= 0.5 * yd * np.linalg.slogdet(C)[1]
            ll -= 0.5 * yd * ntest * np.log(2 * np.pi)
            return ll

        ll_block = 0.0
        ll_block_diag = 0.0
        se_block = 0.0
        for t, idxs in enumerate(test_blocks):
            if len(idxs) == 0:
                continue
            Yt = self.Ytest[idxs]
            PM, PC = results[t]
            ll_block += gaussian_ll(Yt, PM, PC)
            ll_block_diag += gaussian_ll(Yt, PM, np.diag(np.diag(PC)))
            se_block += np.sum((Yt - PM) ** 2)

        ntest, yd = self.Ytest.shape
        Ymean = np.mean(self.SY, axis=0)
        se_baseline = np.sum((self.Ytest - Ymean) ** 2)
        smse = se_block / se_baseline

        Ystd = np.std(self.SY, axis=0)
        ll_baseline = np.sum(
            [
                np.sum(
                    -0.5 * ((self.Ytest[:, i] - Ymean[i]) / Ystd[i]) ** 2
                    - 0.5 * np.log(2 * np.pi * Ystd[i] ** 2)
                )
                for i in range(yd)
            ]
        )
        mll_baseline = ll_baseline / (ntest * yd)
        msll_block = ll_block / (ntest * yd) - mll_baseline
        msll_block_diag = ll_block_diag / (ntest * yd) - mll_baseline
        return smse, msll_block, msll_block_diag


def sample_data(n, ntrain, lscale, obs_std, yd, seed, centers, noise_var, rpc_blocksize=-1):
    """Dataset cache-on-disk keyed by generation params
    (reference ``gprfopt.py:204-225``)."""
    sample_basedir = os.path.join(exp_base_dir(), "synthetic_datasets")
    mkdir_p(sample_basedir)
    # GPRF_SAMPLER selects the large-n prior-sampling path (synthetic.py:
    # sample_y): default = banded exact truncated-support draw above 20k,
    # "vecchia" = the legacy rounds-1-4 approximate sampler (keeps the
    # historical unsuffixed cache names), "hi" = high-fidelity Vecchia.
    # Different samplers are different data realizations -> distinct caches.
    from gprf_tpu.data.synthetic import sampler_suffix

    sample_fname = "%d_%d_%.6f_%.6f_%d_%d%s%s.pkl" % (
        n,
        ntrain,
        lscale,
        obs_std,
        yd,
        seed,
        "" if noise_var == 0.01 else "_%.4f" % noise_var,
        sampler_suffix(n),
    )
    sample_fname_full = os.path.join(sample_basedir, sample_fname)
    try:
        with open(sample_fname_full, "rb") as f:
            sdata = pickle.load(f)
    except (IOError, OSError, pickle.UnpicklingError, EOFError):
        sdata = SampledData(
            n=n,
            ntrain=ntrain,
            lscale=lscale,
            obs_std=obs_std,
            seed=seed,
            yd=yd,
            noise_var=noise_var,
        )
        with open(sample_fname_full, "wb") as f:
            pickle.dump(sdata, f)

    if centers is not None:
        sdata.set_centers(centers)
    else:
        np.random.seed(seed)
        sdata.cluster_rpc(rpc_blocksize)
    return sdata
