"""Shim of the reference's ``vietTTS.nat`` subpackage over the port."""
