"""Small shared utilities: varint codec, checksums."""
