"""DIPNet surrogate training for the helmholtz problem (port of
``applications/helmholtz_training.py``): the confusion training driver's
pipeline (``confusion_training.train_driver``) with the helmholtz variants,
the DIPResNet's sigmoid residual activation and the helmholtz artifact
directory.

    python -m hippyflow_tpu_torch.applications.helmholtz_training \\
        --data_dir helmholtz_output/ [--device cpu]

Run it after ``helmholtz_setup``.
"""

from __future__ import annotations

import os

import numpy as np

from .confusion_training import train_driver, training_parser


def load_helmholtz_data(data_dir: str, rescale: bool = False,
                        derivatives: bool = False, n_data: int | None = None):
    """Load the consolidated helmholtz (m, q) data with the reference
    loader's options (``helmholtz_utilities.py:17-114``): ``n_data``
    truncation, ``rescale`` standard-scaling of m and q (zero mean and unit
    variance per feature) and ``derivatives``, the Jacobian-SVD bundle.

    Returns (m_data, q_data) or, with ``derivatives=True``, a dict with
    m_data and q_data, and U_data, sigma_data and V_data where
    ``Jsvd_data.npz`` exists.  ``rescale`` with ``derivatives`` raises, as
    in the reference: scaled data invalidate the stored Jacobians."""
    with np.load(os.path.join(data_dir, "mq_data.npz")) as data:
        m_data, q_data = data["m_data"], data["q_data"]
    if n_data is not None:
        m_data, q_data = m_data[:n_data], q_data[:n_data]
    if rescale:
        if derivatives:
            raise NotImplementedError(
                "rescale with derivative data is not defined: scaling (m, q) "
                "invalidates the stored Jacobian factors "
                "(reference helmholtz_utilities.py:109)")

        def scale(x):
            sd = x.std(axis=0)
            return (x - x.mean(axis=0)) / np.where(sd > 0, sd, 1.0)

        m_data, q_data = scale(m_data), scale(q_data)
    if not derivatives:
        return m_data, q_data
    out = {"m_data": m_data, "q_data": q_data}
    jsvd_path = os.path.join(data_dir, "Jsvd_data.npz")
    if os.path.exists(jsvd_path):
        with np.load(jsvd_path) as jsvd:
            for k in ("U_data", "sigma_data", "V_data"):
                out[k] = jsvd[k] if n_data is None else jsvd[k][:n_data]
    else:
        print("No derivative data".center(80))
    return out


def main(argv=None):
    args = training_parser("helmholtz_output/", "as_resnet").parse_args(argv)
    return train_driver(args, *load_helmholtz_data(args.data_dir),
                        residual_activation="sigmoid", h1_needs_projector=True)


if __name__ == "__main__":
    main()
