"""Model configs, parameter trees and the llama forward/decode."""
