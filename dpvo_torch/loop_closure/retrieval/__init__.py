from .retrieval_native import RetrievalDBOW
from .image_cache import ImageCache

__all__ = ['RetrievalDBOW', 'ImageCache']
