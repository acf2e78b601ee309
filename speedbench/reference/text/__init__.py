"""A frozen copy of the port's text frontend (cleaners, CMUdict g2p,
symbol ids), so that the reference encodes its texts itself."""

from speedbench.reference.text.processing import TextProcessing
from speedbench.reference.text.symbols import get_symbols
