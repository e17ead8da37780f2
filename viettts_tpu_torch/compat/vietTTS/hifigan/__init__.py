"""Shim of the reference's ``vietTTS.hifigan`` subpackage over the port."""
