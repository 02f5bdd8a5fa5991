"""Data-size sweep for helmholtz DIPNet accuracy curves (port of
``applications/helmholtz_multirun.py``): ``confusion_multirun.sweep`` with
the helmholtz DIPResNet (sigmoid residual activation), its default
architectures and the helmholtz artifact directory.

    python -m hippyflow_tpu_torch.applications.helmholtz_multirun \\
        --data_dir helmholtz_output/ [--device cpu]
"""

from __future__ import annotations

from .confusion_multirun import sweep_main


def main(argv=None):
    return sweep_main(argv, "helmholtz_output/", "as_resnet,kle_dense,generic_dense",
                      "sigmoid")


if __name__ == "__main__":
    main()
