"""Dtype policy and metric logging of the port."""
