from .loader import LoaderCfg, SyntheticLoader
from .synthetic import CorpusCfg, bigram_entropy, sample_batch
