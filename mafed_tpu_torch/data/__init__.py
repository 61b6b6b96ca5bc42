"""Data helpers of the port: device-side image normalisation and the tokenizer."""
