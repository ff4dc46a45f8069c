"""Generated protobuf modules (protoc --python_out from nornic.proto)."""
