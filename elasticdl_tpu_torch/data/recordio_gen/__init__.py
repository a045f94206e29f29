"""Dataset -> RecordIO converters (reference:
`elasticdl_tpu/data/recordio_gen/`)."""
