"""DressCode inference CLI of the PyTorch port: the counterpart of
``idmvton_tpu/cli/infer_dc.py`` (the reference's inference_dc.py entry
point); delegates to ``cli/infer.py`` with ``--dataset dresscode``.
"""

import sys

from idmvton_tpu_torch.cli.infer import main as _main


def main(argv=None):
    args = list(argv) if argv is not None else sys.argv[1:]
    _main(["--dataset", "dresscode"] + args)


if __name__ == "__main__":
    main()
