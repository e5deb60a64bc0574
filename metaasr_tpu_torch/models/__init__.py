from metaasr_tpu_torch.models.vgg_blstm import VGGBLSTMCTC
from metaasr_tpu_torch.models.transformer import TransformerASR
from metaasr_tpu_torch.models.conformer import ConformerEncoder

__all__ = ["VGGBLSTMCTC", "TransformerASR", "ConformerEncoder"]
