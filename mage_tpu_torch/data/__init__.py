from mage_tpu_torch.data.recordio import RecordReader, RecordWriter
from mage_tpu_torch.data.readers import open_blob_store
from mage_tpu_torch.data.tokenizers import VocabTokenizer, MNIST_VOCAB, CATERV1_VOCAB, CATERV2_VOCAB
from mage_tpu_torch.data.loader import Loader
