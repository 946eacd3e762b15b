"""Model configs, parameter trees and the decoder forward/decode (Llama,
OPT, Falcon, Mixtral)."""
