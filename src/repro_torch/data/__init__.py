from repro_torch.data.pipeline import (DataConfig, DataState, TokenStream,
                                       make_stream)

__all__ = ["DataConfig", "DataState", "TokenStream", "make_stream"]
