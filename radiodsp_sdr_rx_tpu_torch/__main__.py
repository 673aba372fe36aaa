import sys

from radiodsp_sdr_rx_tpu_torch.cli import main

sys.exit(main())
