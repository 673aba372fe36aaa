"""Receiver models: the configuration, the reference chain (``Receiver``,
``ReceiverBank``) and the fused channel banks."""

from radiodsp_sdr_rx_tpu_torch.models.config import (
    AGCMode,
    AudioFilter,
    DemodMode,
    FilterWindow,
    NRMode,
    ReceiverConfig,
)
from radiodsp_sdr_rx_tpu_torch.models.fused import (
    FusedAMBank,
    FusedNRBank,
    FusedSAMBank,
    FusedSSBBank,
)
from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver, ReceiverBank, ReceiverState

__all__ = ["AGCMode", "AudioFilter", "DemodMode", "FilterWindow", "FusedAMBank",
           "FusedNRBank", "FusedSAMBank", "FusedSSBBank", "NRMode", "Receiver",
           "ReceiverBank", "ReceiverConfig", "ReceiverState"]
