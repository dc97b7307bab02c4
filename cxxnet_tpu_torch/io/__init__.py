"""Data iterators of the PyTorch port (the port of ``cxxnet_tpu/io``).

The port's own copy of the iterator protocol (:class:`DataBatch`,
:class:`DataIter`), the in-memory batch cursor, the ``synthetic`` and
``synthetic_lm`` iterators, whose data is bit-equal to the JAX
package's from the same seeds (numpy draws it), the ``mnist`` idx
reader, the ``csv`` reader, the ``imgrec`` image-record pipeline
(record files and BinaryPage packs, PNG and JPEG decoding, the
augmentations with the affine warp, the mean image, uint8 batches for
the input fold) and the ``img`` image-file iterator, wrapped by the
``threadbuffer`` prefetcher, the ``throttle`` and ``membuffer``
wrappers and ``attachtxt`` (side features joined by instance id into
``extra_data``), whose batches are the JAX package's; the sources read their
worker's share under ``dist_num_worker`` / ``dist_worker_rank``, and
every path goes through the stream layer (:mod:`.stream`: local files
or ``scheme://`` URLs). :func:`create_iterator` builds an iterator chain
from one config section and :func:`close_chain` releases its threads.
"""

from .data import DataBatch, DataIter, close_chain, create_iterator
from .iter_img import AttachTxtIterator, ImageIterator
from .iter_imgrec import ImageRecordIterator
from .iter_mnist import MNISTIterator
from .proc import (CSVIterator, DenseBufferIterator, SyntheticIterator,
                   SyntheticLMIterator, ThreadBufferIterator,
                   ThrottleIterator)

__all__ = ["AttachTxtIterator", "CSVIterator", "DataBatch", "DataIter", "DenseBufferIterator",
           "ImageIterator", "ImageRecordIterator", "MNISTIterator",
           "SyntheticIterator", "SyntheticLMIterator", "ThreadBufferIterator",
           "ThrottleIterator", "close_chain", "create_iterator"]
