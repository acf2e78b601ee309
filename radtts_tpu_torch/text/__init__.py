from radtts_tpu_torch.text.processing import TextProcessing
from radtts_tpu_torch.text.symbols import get_symbols
