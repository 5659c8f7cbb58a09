"""Host milliseconds per decomposition in ``repro_torch.decompose.tiles``:
building the tiles and uploading them (``core/decompose.py`` ``_Tiles`` or
``_FusedGroups``), traced window, mean over decompositions."""
from perfbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, (spans.TILES,))
