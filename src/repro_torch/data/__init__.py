from .pipeline import ImageStream, TokenStream, make_batch_iterator

__all__ = ["ImageStream", "TokenStream", "make_batch_iterator"]
