"""The recsys family: the embedding lookups and EmbeddingBag
(``embedding``) and bert4rec (``bert4rec``)."""
