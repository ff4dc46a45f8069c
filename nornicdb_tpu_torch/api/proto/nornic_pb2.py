# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: nornic.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cnornic.proto\x12\tnornic.v1\"@\n\rSearchRequest\x12\x10\n\x08\x64\x61tabase\x18\x01 \x01(\t\x12\x0e\n\x06vector\x18\x02 \x03(\x02\x12\r\n\x05limit\x18\x03 \x01(\r\"O\n\rHybridRequest\x12\x10\n\x08\x64\x61tabase\x18\x01 \x01(\t\x12\r\n\x05query\x18\x02 \x01(\t\x12\x0e\n\x06vector\x18\x03 \x03(\x02\x12\r\n\x05limit\x18\x04 \x01(\r\";\n\x03Hit\x12\x0f\n\x07node_id\x18\x01 \x01(\t\x12\r\n\x05score\x18\x02 \x01(\x02\x12\x14\n\x0cpayload_json\x18\x03 \x01(\t\"?\n\x0eSearchResponse\x12\x1c\n\x04hits\x18\x01 \x03(\x0b\x32\x0e.nornic.v1.Hit\x12\x0f\n\x07took_ms\x18\x02 \x01(\x01\"\x07\n\x05\x45mpty\"T\n\x17\x43reateCollectionRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x13\n\x0bvector_size\x18\x02 \x01(\r\x12\x10\n\x08\x64istance\x18\x03 \x01(\t\"\'\n\x11\x43ollectionRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\".\n\x17ListCollectionsResponse\x12\x13\n\x0b\x63ollections\x18\x01 \x03(\t\"e\n\x16\x43ollectionInfoResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x14\n\x0cpoints_count\x18\x02 \x01(\x04\x12\x13\n\x0bvector_size\x18\x03 \x01(\r\x12\x10\n\x08\x64istance\x18\x04 \x01(\t\"9\n\x05Point\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0e\n\x06vector\x18\x02 \x03(\x02\x12\x14\n\x0cpayload_json\x18\x03 \x01(\t\"E\n\rUpsertRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12 \n\x06points\x18\x02 \x03(\x0b\x32\x10.nornic.v1.Point\"\xbe\x01\n\x13SearchPointsRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x0e\n\x06vector\x18\x02 \x03(\x02\x12\r\n\x05limit\x18\x03 \x01(\r\x12\x13\n\x0b\x66ilter_json\x18\x04 \x01(\t\x12\x14\n\x0cwith_payload\x18\x05 \x01(\x08\x12\x13\n\x0bwith_vector\x18\x06 \x01(\x08\x12\x17\n\x0fscore_threshold\x18\x07 \x01(\x02\x12\x1b\n\x13has_score_threshold\x18\x08 \x01(\x08\"N\n\x0bScoredPoint\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05score\x18\x02 \x01(\x02\x12\x14\n\x0cpayload_json\x18\x03 \x01(\t\x12\x0e\n\x06vector\x18\x04 \x03(\x02\"O\n\x14SearchPointsResponse\x12&\n\x06points\x18\x01 \x03(\x0b\x32\x16.nornic.v1.ScoredPoint\x12\x0f\n\x07took_ms\x18\x02 \x01(\x01\"6\n\x13\x44\x65letePointsRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x0b\n\x03ids\x18\x02 \x03(\t\"(\n\x0b\x41\x63kResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\x1e\n\rCountResponse\x12\r\n\x05\x63ount\x18\x01 \x01(\x04\x32\x8d\x01\n\rSearchService\x12=\n\x06Search\x12\x18.nornic.v1.SearchRequest\x1a\x19.nornic.v1.SearchResponse\x12=\n\x06Hybrid\x12\x18.nornic.v1.HybridRequest\x1a\x19.nornic.v1.SearchResponse2\xe0\x04\n\rQdrantService\x12N\n\x10\x43reateCollection\x12\".nornic.v1.CreateCollectionRequest\x1a\x16.nornic.v1.AckResponse\x12H\n\x10\x44\x65leteCollection\x12\x1c.nornic.v1.CollectionRequest\x1a\x16.nornic.v1.AckResponse\x12G\n\x0fListCollections\x12\x10.nornic.v1.Empty\x1a\".nornic.v1.ListCollectionsResponse\x12P\n\rGetCollection\x12\x1c.nornic.v1.CollectionRequest\x1a!.nornic.v1.CollectionInfoResponse\x12:\n\x06Upsert\x12\x18.nornic.v1.UpsertRequest\x1a\x16.nornic.v1.AckResponse\x12O\n\x0cSearchPoints\x12\x1e.nornic.v1.SearchPointsRequest\x1a\x1f.nornic.v1.SearchPointsResponse\x12\x46\n\x0c\x44\x65letePoints\x12\x1e.nornic.v1.DeletePointsRequest\x1a\x16.nornic.v1.AckResponse\x12\x45\n\x0b\x43ountPoints\x12\x1c.nornic.v1.CollectionRequest\x1a\x18.nornic.v1.CountResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'nornic_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SEARCHREQUEST._serialized_start=27
  _SEARCHREQUEST._serialized_end=91
  _HYBRIDREQUEST._serialized_start=93
  _HYBRIDREQUEST._serialized_end=172
  _HIT._serialized_start=174
  _HIT._serialized_end=233
  _SEARCHRESPONSE._serialized_start=235
  _SEARCHRESPONSE._serialized_end=298
  _EMPTY._serialized_start=300
  _EMPTY._serialized_end=307
  _CREATECOLLECTIONREQUEST._serialized_start=309
  _CREATECOLLECTIONREQUEST._serialized_end=393
  _COLLECTIONREQUEST._serialized_start=395
  _COLLECTIONREQUEST._serialized_end=434
  _LISTCOLLECTIONSRESPONSE._serialized_start=436
  _LISTCOLLECTIONSRESPONSE._serialized_end=482
  _COLLECTIONINFORESPONSE._serialized_start=484
  _COLLECTIONINFORESPONSE._serialized_end=585
  _POINT._serialized_start=587
  _POINT._serialized_end=644
  _UPSERTREQUEST._serialized_start=646
  _UPSERTREQUEST._serialized_end=715
  _SEARCHPOINTSREQUEST._serialized_start=718
  _SEARCHPOINTSREQUEST._serialized_end=908
  _SCOREDPOINT._serialized_start=910
  _SCOREDPOINT._serialized_end=988
  _SEARCHPOINTSRESPONSE._serialized_start=990
  _SEARCHPOINTSRESPONSE._serialized_end=1069
  _DELETEPOINTSREQUEST._serialized_start=1071
  _DELETEPOINTSREQUEST._serialized_end=1125
  _ACKRESPONSE._serialized_start=1127
  _ACKRESPONSE._serialized_end=1167
  _COUNTRESPONSE._serialized_start=1169
  _COUNTRESPONSE._serialized_end=1199
  _SEARCHSERVICE._serialized_start=1202
  _SEARCHSERVICE._serialized_end=1343
  _QDRANTSERVICE._serialized_start=1346
  _QDRANTSERVICE._serialized_end=1954
# @@protoc_insertion_point(module_scope)
