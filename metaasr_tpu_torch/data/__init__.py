from metaasr_tpu_torch.data.tokenizer import CharTokenizer, PhoneTokenizer
from metaasr_tpu_torch.data.dataset import AccentDataset, Manifest, Utterance
from metaasr_tpu_torch.data.sampler import BucketBatcher, TaskSampler, collate

__all__ = [
    "CharTokenizer",
    "PhoneTokenizer",
    "AccentDataset",
    "Manifest",
    "Utterance",
    "TaskSampler",
    "BucketBatcher",
    "collate",
]
