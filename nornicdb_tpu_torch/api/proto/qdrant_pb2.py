# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: qdrant.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cqdrant.proto\x12\x06qdrant\"\xe8\x01\n\x05Value\x12\'\n\nnull_value\x18\x01 \x01(\x0e\x32\x11.qdrant.NullValueH\x00\x12\x16\n\x0c\x64ouble_value\x18\x02 \x01(\x01H\x00\x12\x17\n\rinteger_value\x18\x03 \x01(\x03H\x00\x12\x16\n\x0cstring_value\x18\x04 \x01(\tH\x00\x12\x14\n\nbool_value\x18\x05 \x01(\x08H\x00\x12&\n\x0cstruct_value\x18\x06 \x01(\x0b\x32\x0e.qdrant.StructH\x00\x12\'\n\nlist_value\x18\x07 \x01(\x0b\x32\x11.qdrant.ListValueH\x00\x42\x06\n\x04kind\"r\n\x06Struct\x12*\n\x06\x66ields\x18\x01 \x03(\x0b\x32\x1a.qdrant.Struct.FieldsEntry\x1a<\n\x0b\x46ieldsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x1c\n\x05value\x18\x02 \x01(\x0b\x32\r.qdrant.Value:\x02\x38\x01\"*\n\tListValue\x12\x1d\n\x06values\x18\x01 \x03(\x0b\x32\r.qdrant.Value\"@\n\x0cVectorParams\x12\x0c\n\x04size\x18\x01 \x01(\x04\x12\"\n\x08\x64istance\x18\x02 \x01(\x0e\x32\x10.qdrant.Distance\"\x82\x01\n\x0fVectorParamsMap\x12-\n\x03map\x18\x01 \x03(\x0b\x32 .qdrant.VectorParamsMap.MapEntry\x1a@\n\x08MapEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12#\n\x05value\x18\x02 \x01(\x0b\x32\x14.qdrant.VectorParams:\x02\x38\x01\"p\n\rVectorsConfig\x12&\n\x06params\x18\x01 \x01(\x0b\x32\x14.qdrant.VectorParamsH\x00\x12-\n\nparams_map\x18\x02 \x01(\x0b\x32\x17.qdrant.VectorParamsMapH\x00\x42\x08\n\x06\x63onfig\"\xaa\x02\n\x10\x43reateCollection\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x19\n\x0cshard_number\x18\x07 \x01(\rH\x00\x88\x01\x01\x12\x1c\n\x0fon_disk_payload\x18\x08 \x01(\x08H\x01\x88\x01\x01\x12\x14\n\x07timeout\x18\t \x01(\x04H\x02\x88\x01\x01\x12\x32\n\x0evectors_config\x18\n \x01(\x0b\x32\x15.qdrant.VectorsConfigH\x03\x88\x01\x01\x12\x1f\n\x12replication_factor\x18\x0b \x01(\rH\x04\x88\x01\x01\x42\x0f\n\r_shard_numberB\x12\n\x10_on_disk_payloadB\n\n\x08_timeoutB\x11\n\x0f_vectors_configB\x15\n\x13_replication_factor\"M\n\x10\x44\x65leteCollection\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x14\n\x07timeout\x18\x02 \x01(\x04H\x00\x88\x01\x01\x42\n\n\x08_timeout\";\n\x1b\x43ollectionOperationResponse\x12\x0e\n\x06result\x18\x01 \x01(\x08\x12\x0c\n\x04time\x18\x02 \x01(\x01\"\x18\n\x16ListCollectionsRequest\"%\n\x15\x43ollectionDescription\x12\x0c\n\x04name\x18\x01 \x01(\t\"[\n\x17ListCollectionsResponse\x12\x32\n\x0b\x63ollections\x18\x01 \x03(\x0b\x32\x1d.qdrant.CollectionDescription\x12\x0c\n\x04time\x18\x02 \x01(\x01\"3\n\x18GetCollectionInfoRequest\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\"<\n\x10\x43ollectionConfig\x12(\n\x06params\x18\x01 \x01(\x0b\x32\x18.qdrant.CollectionParams\"Y\n\x10\x43ollectionParams\x12\x32\n\x0evectors_config\x18\n \x01(\x0b\x32\x15.qdrant.VectorsConfigH\x00\x88\x01\x01\x42\x11\n\x0f_vectors_config\"\xbf\x01\n\x0e\x43ollectionInfo\x12(\n\x06status\x18\x01 \x01(\x0e\x32\x18.qdrant.CollectionStatus\x12\x15\n\rvectors_count\x18\x03 \x01(\x04\x12\x16\n\x0esegments_count\x18\x04 \x01(\x04\x12(\n\x06\x63onfig\x18\x07 \x01(\x0b\x32\x18.qdrant.CollectionConfig\x12\x19\n\x0cpoints_count\x18\t \x01(\x04H\x00\x88\x01\x01\x42\x0f\n\r_points_count\"Q\n\x19GetCollectionInfoResponse\x12&\n\x06result\x18\x01 \x01(\x0b\x32\x16.qdrant.CollectionInfo\x12\x0c\n\x04time\x18\x02 \x01(\x01\"2\n\x17\x43ollectionExistsRequest\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\"\"\n\x10\x43ollectionExists\x12\x0e\n\x06\x65xists\x18\x01 \x01(\x08\"R\n\x18\x43ollectionExistsResponse\x12(\n\x06result\x18\x01 \x01(\x0b\x32\x18.qdrant.CollectionExists\x12\x0c\n\x04time\x18\x02 \x01(\x01\"<\n\x07PointId\x12\r\n\x03num\x18\x01 \x01(\x04H\x00\x12\x0e\n\x04uuid\x18\x02 \x01(\tH\x00\x42\x12\n\x10point_id_options\"\x16\n\x06Vector\x12\x0c\n\x04\x64\x61ta\x18\x01 \x03(\x02\"\x82\x01\n\x0cNamedVectors\x12\x32\n\x07vectors\x18\x01 \x03(\x0b\x32!.qdrant.NamedVectors.VectorsEntry\x1a>\n\x0cVectorsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x1d\n\x05value\x18\x02 \x01(\x0b\x32\x0e.qdrant.Vector:\x02\x38\x01\"g\n\x07Vectors\x12 \n\x06vector\x18\x01 \x01(\x0b\x32\x0e.qdrant.VectorH\x00\x12\'\n\x07vectors\x18\x02 \x01(\x0b\x32\x14.qdrant.NamedVectorsH\x00\x42\x11\n\x0fvectors_options\"\xd5\x01\n\x0bPointStruct\x12\x1b\n\x02id\x18\x01 \x01(\x0b\x32\x0f.qdrant.PointId\x12\x31\n\x07payload\x18\x03 \x03(\x0b\x32 .qdrant.PointStruct.PayloadEntry\x12%\n\x07vectors\x18\x04 \x01(\x0b\x32\x0f.qdrant.VectorsH\x00\x88\x01\x01\x1a=\n\x0cPayloadEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x1c\n\x05value\x18\x02 \x01(\x0b\x32\r.qdrant.Value:\x02\x38\x01\x42\n\n\x08_vectorsJ\x04\x08\x02\x10\x03\"8\n\rWriteOrdering\x12\'\n\x04type\x18\x01 \x01(\x0e\x32\x19.qdrant.WriteOrderingType\"\xa3\x01\n\x0cUpsertPoints\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x11\n\x04wait\x18\x02 \x01(\x08H\x00\x88\x01\x01\x12#\n\x06points\x18\x03 \x03(\x0b\x32\x13.qdrant.PointStruct\x12,\n\x08ordering\x18\x04 \x01(\x0b\x32\x15.qdrant.WriteOrderingH\x01\x88\x01\x01\x42\x07\n\x05_waitB\x0b\n\t_ordering\"`\n\x0cUpdateResult\x12\x19\n\x0coperation_id\x18\x01 \x01(\x04H\x00\x88\x01\x01\x12$\n\x06status\x18\x02 \x01(\x0e\x32\x14.qdrant.UpdateStatusB\x0f\n\r_operation_id\"M\n\x17PointsOperationResponse\x12$\n\x06result\x18\x01 \x01(\x0b\x32\x14.qdrant.UpdateResult\x12\x0c\n\x04time\x18\x02 \x01(\x01\"-\n\rPointsIdsList\x12\x1c\n\x03ids\x18\x01 \x03(\x0b\x32\x0f.qdrant.PointId\"u\n\x0ePointsSelector\x12\'\n\x06points\x18\x01 \x01(\x0b\x32\x15.qdrant.PointsIdsListH\x00\x12 \n\x06\x66ilter\x18\x02 \x01(\x0b\x32\x0e.qdrant.FilterH\x00\x42\x18\n\x16points_selector_one_of\"\xa6\x01\n\x0c\x44\x65letePoints\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x11\n\x04wait\x18\x02 \x01(\x08H\x00\x88\x01\x01\x12&\n\x06points\x18\x03 \x01(\x0b\x32\x16.qdrant.PointsSelector\x12,\n\x08ordering\x18\x04 \x01(\x0b\x32\x15.qdrant.WriteOrderingH\x01\x88\x01\x01\x42\x07\n\x05_waitB\x0b\n\t_ordering\"q\n\x06\x46ilter\x12!\n\x06should\x18\x01 \x03(\x0b\x32\x11.qdrant.Condition\x12\x1f\n\x04must\x18\x02 \x03(\x0b\x32\x11.qdrant.Condition\x12#\n\x08must_not\x18\x03 \x03(\x0b\x32\x11.qdrant.Condition\"\xee\x01\n\tCondition\x12\'\n\x05\x66ield\x18\x01 \x01(\x0b\x32\x16.qdrant.FieldConditionH\x00\x12,\n\x08is_empty\x18\x02 \x01(\x0b\x32\x18.qdrant.IsEmptyConditionH\x00\x12(\n\x06has_id\x18\x03 \x01(\x0b\x32\x16.qdrant.HasIdConditionH\x00\x12 \n\x06\x66ilter\x18\x04 \x01(\x0b\x32\x0e.qdrant.FilterH\x00\x12*\n\x07is_null\x18\x05 \x01(\x0b\x32\x17.qdrant.IsNullConditionH\x00\x42\x12\n\x10\x63ondition_one_of\"\x1f\n\x10IsEmptyCondition\x12\x0b\n\x03key\x18\x01 \x01(\t\"\x1e\n\x0fIsNullCondition\x12\x0b\n\x03key\x18\x01 \x01(\t\"1\n\x0eHasIdCondition\x12\x1f\n\x06has_id\x18\x01 \x03(\x0b\x32\x0f.qdrant.PointId\"Y\n\x0e\x46ieldCondition\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x1c\n\x05match\x18\x02 \x01(\x0b\x32\r.qdrant.Match\x12\x1c\n\x05range\x18\x03 \x01(\x0b\x32\r.qdrant.Range\"_\n\x05Match\x12\x11\n\x07keyword\x18\x01 \x01(\tH\x00\x12\x11\n\x07integer\x18\x02 \x01(\x03H\x00\x12\x11\n\x07\x62oolean\x18\x03 \x01(\x08H\x00\x12\x0e\n\x04text\x18\x04 \x01(\tH\x00\x42\r\n\x0bmatch_value\"k\n\x05Range\x12\x0f\n\x02lt\x18\x01 \x01(\x01H\x00\x88\x01\x01\x12\x0f\n\x02gt\x18\x02 \x01(\x01H\x01\x88\x01\x01\x12\x10\n\x03gte\x18\x03 \x01(\x01H\x02\x88\x01\x01\x12\x10\n\x03lte\x18\x04 \x01(\x01H\x03\x88\x01\x01\x42\x05\n\x03_ltB\x05\n\x03_gtB\x06\n\x04_gteB\x06\n\x04_lte\"\xa1\x01\n\x13WithPayloadSelector\x12\x10\n\x06\x65nable\x18\x01 \x01(\x08H\x00\x12\x31\n\x07include\x18\x02 \x01(\x0b\x32\x1e.qdrant.PayloadIncludeSelectorH\x00\x12\x31\n\x07\x65xclude\x18\x03 \x01(\x0b\x32\x1e.qdrant.PayloadExcludeSelectorH\x00\x42\x12\n\x10selector_options\"(\n\x16PayloadIncludeSelector\x12\x0e\n\x06\x66ields\x18\x01 \x03(\t\"(\n\x16PayloadExcludeSelector\x12\x0e\n\x06\x66ields\x18\x01 \x03(\t\"g\n\x13WithVectorsSelector\x12\x10\n\x06\x65nable\x18\x01 \x01(\x08H\x00\x12*\n\x07include\x18\x02 \x01(\x0b\x32\x17.qdrant.VectorsSelectorH\x00\x42\x12\n\x10selector_options\" \n\x0fVectorsSelector\x12\r\n\x05names\x18\x01 \x03(\t\"\xe4\x02\n\x0cSearchPoints\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x0e\n\x06vector\x18\x02 \x03(\x02\x12\x1e\n\x06\x66ilter\x18\x03 \x01(\x0b\x32\x0e.qdrant.Filter\x12\r\n\x05limit\x18\x04 \x01(\x04\x12\x31\n\x0cwith_payload\x18\x06 \x01(\x0b\x32\x1b.qdrant.WithPayloadSelector\x12\x1c\n\x0fscore_threshold\x18\x08 \x01(\x02H\x00\x88\x01\x01\x12\x13\n\x06offset\x18\t \x01(\x04H\x01\x88\x01\x01\x12\x18\n\x0bvector_name\x18\n \x01(\tH\x02\x88\x01\x01\x12\x36\n\x0cwith_vectors\x18\x0b \x01(\x0b\x32\x1b.qdrant.WithVectorsSelectorH\x03\x88\x01\x01\x42\x12\n\x10_score_thresholdB\t\n\x07_offsetB\x0e\n\x0c_vector_nameB\x0f\n\r_with_vectorsJ\x04\x08\x05\x10\x06\"\xf5\x01\n\x0bScoredPoint\x12\x1b\n\x02id\x18\x01 \x01(\x0b\x32\x0f.qdrant.PointId\x12\x31\n\x07payload\x18\x02 \x03(\x0b\x32 .qdrant.ScoredPoint.PayloadEntry\x12\r\n\x05score\x18\x03 \x01(\x02\x12\x0f\n\x07version\x18\x05 \x01(\x04\x12%\n\x07vectors\x18\x06 \x01(\x0b\x32\x0f.qdrant.VectorsH\x00\x88\x01\x01\x1a=\n\x0cPayloadEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x1c\n\x05value\x18\x02 \x01(\x0b\x32\r.qdrant.Value:\x02\x38\x01\x42\n\n\x08_vectorsJ\x04\x08\x04\x10\x05\"C\n\x0eSearchResponse\x12#\n\x06result\x18\x01 \x03(\x0b\x32\x13.qdrant.ScoredPoint\x12\x0c\n\x04time\x18\x02 \x01(\x01\"\xc4\x01\n\tGetPoints\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x1c\n\x03ids\x18\x02 \x03(\x0b\x32\x0f.qdrant.PointId\x12\x31\n\x0cwith_payload\x18\x04 \x01(\x0b\x32\x1b.qdrant.WithPayloadSelector\x12\x36\n\x0cwith_vectors\x18\x05 \x01(\x0b\x32\x1b.qdrant.WithVectorsSelectorH\x00\x88\x01\x01\x42\x0f\n\r_with_vectorsJ\x04\x08\x03\x10\x04\"\xdb\x01\n\x0eRetrievedPoint\x12\x1b\n\x02id\x18\x01 \x01(\x0b\x32\x0f.qdrant.PointId\x12\x34\n\x07payload\x18\x02 \x03(\x0b\x32#.qdrant.RetrievedPoint.PayloadEntry\x12%\n\x07vectors\x18\x04 \x01(\x0b\x32\x0f.qdrant.VectorsH\x00\x88\x01\x01\x1a=\n\x0cPayloadEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x1c\n\x05value\x18\x02 \x01(\x0b\x32\r.qdrant.Value:\x02\x38\x01\x42\n\n\x08_vectorsJ\x04\x08\x03\x10\x04\"C\n\x0bGetResponse\x12&\n\x06result\x18\x01 \x03(\x0b\x32\x16.qdrant.RetrievedPoint\x12\x0c\n\x04time\x18\x02 \x01(\x01\"\x98\x02\n\x0cScrollPoints\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x1e\n\x06\x66ilter\x18\x02 \x01(\x0b\x32\x0e.qdrant.Filter\x12$\n\x06offset\x18\x03 \x01(\x0b\x32\x0f.qdrant.PointIdH\x00\x88\x01\x01\x12\x12\n\x05limit\x18\x04 \x01(\rH\x01\x88\x01\x01\x12\x31\n\x0cwith_payload\x18\x06 \x01(\x0b\x32\x1b.qdrant.WithPayloadSelector\x12\x36\n\x0cwith_vectors\x18\x07 \x01(\x0b\x32\x1b.qdrant.WithVectorsSelectorH\x02\x88\x01\x01\x42\t\n\x07_offsetB\x08\n\x06_limitB\x0f\n\r_with_vectorsJ\x04\x08\x05\x10\x06\"\x8b\x01\n\x0eScrollResponse\x12.\n\x10next_page_offset\x18\x01 \x01(\x0b\x32\x0f.qdrant.PointIdH\x00\x88\x01\x01\x12&\n\x06result\x18\x02 \x03(\x0b\x32\x16.qdrant.RetrievedPoint\x12\x0c\n\x04time\x18\x03 \x01(\x01\x42\x13\n\x11_next_page_offset\"d\n\x0b\x43ountPoints\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x1e\n\x06\x66ilter\x18\x02 \x01(\x0b\x32\x0e.qdrant.Filter\x12\x12\n\x05\x65xact\x18\x03 \x01(\x08H\x00\x88\x01\x01\x42\x08\n\x06_exact\"\x1c\n\x0b\x43ountResult\x12\r\n\x05\x63ount\x18\x01 \x01(\x04\"B\n\rCountResponse\x12#\n\x06result\x18\x01 \x01(\x0b\x32\x13.qdrant.CountResult\x12\x0c\n\x04time\x18\x02 \x01(\x01\":\n\x0b\x43reateAlias\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x12\n\nalias_name\x18\x02 \x01(\t\"=\n\x0bRenameAlias\x12\x16\n\x0eold_alias_name\x18\x01 \x01(\t\x12\x16\n\x0enew_alias_name\x18\x02 \x01(\t\"!\n\x0b\x44\x65leteAlias\x12\x12\n\nalias_name\x18\x01 \x01(\t\"\xa2\x01\n\x0f\x41liasOperations\x12+\n\x0c\x63reate_alias\x18\x01 \x01(\x0b\x32\x13.qdrant.CreateAliasH\x00\x12+\n\x0crename_alias\x18\x02 \x01(\x0b\x32\x13.qdrant.RenameAliasH\x00\x12+\n\x0c\x64\x65lete_alias\x18\x03 \x01(\x0b\x32\x13.qdrant.DeleteAliasH\x00\x42\x08\n\x06\x61\x63tion\"[\n\rChangeAliases\x12(\n\x07\x61\x63tions\x18\x01 \x03(\x0b\x32\x17.qdrant.AliasOperations\x12\x14\n\x07timeout\x18\x02 \x01(\x04H\x00\x88\x01\x01\x42\n\n\x08_timeout\"7\n\x1cListCollectionAliasesRequest\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\"\x14\n\x12ListAliasesRequest\"?\n\x10\x41liasDescription\x12\x12\n\nalias_name\x18\x01 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x02 \x01(\t\"N\n\x13ListAliasesResponse\x12)\n\x07\x61liases\x18\x01 \x03(\x0b\x32\x18.qdrant.AliasDescription\x12\x0c\n\x04time\x18\x02 \x01(\x01\"\x1b\n\x19\x43reateFullSnapshotRequest\"\x1a\n\x18ListFullSnapshotsRequest\"2\n\x19\x44\x65leteFullSnapshotRequest\x12\x15\n\rsnapshot_name\x18\x01 \x01(\t\"0\n\x15\x43reateSnapshotRequest\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\"/\n\x14ListSnapshotsRequest\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\"G\n\x15\x44\x65leteSnapshotRequest\x12\x17\n\x0f\x63ollection_name\x18\x01 \x01(\t\x12\x15\n\rsnapshot_name\x18\x02 \x01(\t\"H\n\x13SnapshotDescription\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x15\n\rcreation_time\x18\x02 \x01(\x01\x12\x0c\n\x04size\x18\x03 \x01(\x03\"a\n\x16\x43reateSnapshotResponse\x12\x39\n\x14snapshot_description\x18\x01 \x01(\x0b\x32\x1b.qdrant.SnapshotDescription\x12\x0c\n\x04time\x18\x02 \x01(\x01\"a\n\x15ListSnapshotsResponse\x12:\n\x15snapshot_descriptions\x18\x01 \x03(\x0b\x32\x1b.qdrant.SnapshotDescription\x12\x0c\n\x04time\x18\x02 \x01(\x01\"&\n\x16\x44\x65leteSnapshotResponse\x12\x0c\n\x04time\x18\x01 \x01(\x01*\x1b\n\tNullValue\x12\x0e\n\nNULL_VALUE\x10\x00*O\n\x08\x44istance\x12\x13\n\x0fUnknownDistance\x10\x00\x12\n\n\x06\x43osine\x10\x01\x12\n\n\x06\x45uclid\x10\x02\x12\x07\n\x03\x44ot\x10\x03\x12\r\n\tManhattan\x10\x04*O\n\x10\x43ollectionStatus\x12\x1b\n\x17UnknownCollectionStatus\x10\x00\x12\t\n\x05Green\x10\x01\x12\n\n\x06Yellow\x10\x02\x12\x07\n\x03Red\x10\x03*5\n\x11WriteOrderingType\x12\x08\n\x04Weak\x10\x00\x12\n\n\x06Medium\x10\x01\x12\n\n\x06Strong\x10\x02*H\n\x0cUpdateStatus\x12\x17\n\x13UnknownUpdateStatus\x10\x00\x12\x10\n\x0c\x41\x63knowledged\x10\x01\x12\r\n\tCompleted\x10\x02\x32\xfc\x04\n\x0b\x43ollections\x12J\n\x03Get\x12 .qdrant.GetCollectionInfoRequest\x1a!.qdrant.GetCollectionInfoResponse\x12G\n\x04List\x12\x1e.qdrant.ListCollectionsRequest\x1a\x1f.qdrant.ListCollectionsResponse\x12G\n\x06\x43reate\x12\x18.qdrant.CreateCollection\x1a#.qdrant.CollectionOperationResponse\x12G\n\x06\x44\x65lete\x12\x18.qdrant.DeleteCollection\x1a#.qdrant.CollectionOperationResponse\x12U\n\x10\x43ollectionExists\x12\x1f.qdrant.CollectionExistsRequest\x1a .qdrant.CollectionExistsResponse\x12K\n\rUpdateAliases\x12\x15.qdrant.ChangeAliases\x1a#.qdrant.CollectionOperationResponse\x12Z\n\x15ListCollectionAliases\x12$.qdrant.ListCollectionAliasesRequest\x1a\x1b.qdrant.ListAliasesResponse\x12\x46\n\x0bListAliases\x12\x1a.qdrant.ListAliasesRequest\x1a\x1b.qdrant.ListAliasesResponse2\xde\x02\n\x06Points\x12?\n\x06Upsert\x12\x14.qdrant.UpsertPoints\x1a\x1f.qdrant.PointsOperationResponse\x12?\n\x06\x44\x65lete\x12\x14.qdrant.DeletePoints\x1a\x1f.qdrant.PointsOperationResponse\x12-\n\x03Get\x12\x11.qdrant.GetPoints\x1a\x13.qdrant.GetResponse\x12\x36\n\x06Search\x12\x14.qdrant.SearchPoints\x1a\x16.qdrant.SearchResponse\x12\x36\n\x06Scroll\x12\x14.qdrant.ScrollPoints\x1a\x16.qdrant.ScrollResponse\x12\x33\n\x05\x43ount\x12\x13.qdrant.CountPoints\x1a\x15.qdrant.CountResponse2\xd1\x03\n\tSnapshots\x12G\n\x06\x43reate\x12\x1d.qdrant.CreateSnapshotRequest\x1a\x1e.qdrant.CreateSnapshotResponse\x12\x43\n\x04List\x12\x1c.qdrant.ListSnapshotsRequest\x1a\x1d.qdrant.ListSnapshotsResponse\x12G\n\x06\x44\x65lete\x12\x1d.qdrant.DeleteSnapshotRequest\x1a\x1e.qdrant.DeleteSnapshotResponse\x12O\n\nCreateFull\x12!.qdrant.CreateFullSnapshotRequest\x1a\x1e.qdrant.CreateSnapshotResponse\x12K\n\x08ListFull\x12 .qdrant.ListFullSnapshotsRequest\x1a\x1d.qdrant.ListSnapshotsResponse\x12O\n\nDeleteFull\x12!.qdrant.DeleteFullSnapshotRequest\x1a\x1e.qdrant.DeleteSnapshotResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'qdrant_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _STRUCT_FIELDSENTRY._options = None
  _STRUCT_FIELDSENTRY._serialized_options = b'8\001'
  _VECTORPARAMSMAP_MAPENTRY._options = None
  _VECTORPARAMSMAP_MAPENTRY._serialized_options = b'8\001'
  _NAMEDVECTORS_VECTORSENTRY._options = None
  _NAMEDVECTORS_VECTORSENTRY._serialized_options = b'8\001'
  _POINTSTRUCT_PAYLOADENTRY._options = None
  _POINTSTRUCT_PAYLOADENTRY._serialized_options = b'8\001'
  _SCOREDPOINT_PAYLOADENTRY._options = None
  _SCOREDPOINT_PAYLOADENTRY._serialized_options = b'8\001'
  _RETRIEVEDPOINT_PAYLOADENTRY._options = None
  _RETRIEVEDPOINT_PAYLOADENTRY._serialized_options = b'8\001'
  _NULLVALUE._serialized_start=7442
  _NULLVALUE._serialized_end=7469
  _DISTANCE._serialized_start=7471
  _DISTANCE._serialized_end=7550
  _COLLECTIONSTATUS._serialized_start=7552
  _COLLECTIONSTATUS._serialized_end=7631
  _WRITEORDERINGTYPE._serialized_start=7633
  _WRITEORDERINGTYPE._serialized_end=7686
  _UPDATESTATUS._serialized_start=7688
  _UPDATESTATUS._serialized_end=7760
  _VALUE._serialized_start=25
  _VALUE._serialized_end=257
  _STRUCT._serialized_start=259
  _STRUCT._serialized_end=373
  _STRUCT_FIELDSENTRY._serialized_start=313
  _STRUCT_FIELDSENTRY._serialized_end=373
  _LISTVALUE._serialized_start=375
  _LISTVALUE._serialized_end=417
  _VECTORPARAMS._serialized_start=419
  _VECTORPARAMS._serialized_end=483
  _VECTORPARAMSMAP._serialized_start=486
  _VECTORPARAMSMAP._serialized_end=616
  _VECTORPARAMSMAP_MAPENTRY._serialized_start=552
  _VECTORPARAMSMAP_MAPENTRY._serialized_end=616
  _VECTORSCONFIG._serialized_start=618
  _VECTORSCONFIG._serialized_end=730
  _CREATECOLLECTION._serialized_start=733
  _CREATECOLLECTION._serialized_end=1031
  _DELETECOLLECTION._serialized_start=1033
  _DELETECOLLECTION._serialized_end=1110
  _COLLECTIONOPERATIONRESPONSE._serialized_start=1112
  _COLLECTIONOPERATIONRESPONSE._serialized_end=1171
  _LISTCOLLECTIONSREQUEST._serialized_start=1173
  _LISTCOLLECTIONSREQUEST._serialized_end=1197
  _COLLECTIONDESCRIPTION._serialized_start=1199
  _COLLECTIONDESCRIPTION._serialized_end=1236
  _LISTCOLLECTIONSRESPONSE._serialized_start=1238
  _LISTCOLLECTIONSRESPONSE._serialized_end=1329
  _GETCOLLECTIONINFOREQUEST._serialized_start=1331
  _GETCOLLECTIONINFOREQUEST._serialized_end=1382
  _COLLECTIONCONFIG._serialized_start=1384
  _COLLECTIONCONFIG._serialized_end=1444
  _COLLECTIONPARAMS._serialized_start=1446
  _COLLECTIONPARAMS._serialized_end=1535
  _COLLECTIONINFO._serialized_start=1538
  _COLLECTIONINFO._serialized_end=1729
  _GETCOLLECTIONINFORESPONSE._serialized_start=1731
  _GETCOLLECTIONINFORESPONSE._serialized_end=1812
  _COLLECTIONEXISTSREQUEST._serialized_start=1814
  _COLLECTIONEXISTSREQUEST._serialized_end=1864
  _COLLECTIONEXISTS._serialized_start=1866
  _COLLECTIONEXISTS._serialized_end=1900
  _COLLECTIONEXISTSRESPONSE._serialized_start=1902
  _COLLECTIONEXISTSRESPONSE._serialized_end=1984
  _POINTID._serialized_start=1986
  _POINTID._serialized_end=2046
  _VECTOR._serialized_start=2048
  _VECTOR._serialized_end=2070
  _NAMEDVECTORS._serialized_start=2073
  _NAMEDVECTORS._serialized_end=2203
  _NAMEDVECTORS_VECTORSENTRY._serialized_start=2141
  _NAMEDVECTORS_VECTORSENTRY._serialized_end=2203
  _VECTORS._serialized_start=2205
  _VECTORS._serialized_end=2308
  _POINTSTRUCT._serialized_start=2311
  _POINTSTRUCT._serialized_end=2524
  _POINTSTRUCT_PAYLOADENTRY._serialized_start=2445
  _POINTSTRUCT_PAYLOADENTRY._serialized_end=2506
  _WRITEORDERING._serialized_start=2526
  _WRITEORDERING._serialized_end=2582
  _UPSERTPOINTS._serialized_start=2585
  _UPSERTPOINTS._serialized_end=2748
  _UPDATERESULT._serialized_start=2750
  _UPDATERESULT._serialized_end=2846
  _POINTSOPERATIONRESPONSE._serialized_start=2848
  _POINTSOPERATIONRESPONSE._serialized_end=2925
  _POINTSIDSLIST._serialized_start=2927
  _POINTSIDSLIST._serialized_end=2972
  _POINTSSELECTOR._serialized_start=2974
  _POINTSSELECTOR._serialized_end=3091
  _DELETEPOINTS._serialized_start=3094
  _DELETEPOINTS._serialized_end=3260
  _FILTER._serialized_start=3262
  _FILTER._serialized_end=3375
  _CONDITION._serialized_start=3378
  _CONDITION._serialized_end=3616
  _ISEMPTYCONDITION._serialized_start=3618
  _ISEMPTYCONDITION._serialized_end=3649
  _ISNULLCONDITION._serialized_start=3651
  _ISNULLCONDITION._serialized_end=3681
  _HASIDCONDITION._serialized_start=3683
  _HASIDCONDITION._serialized_end=3732
  _FIELDCONDITION._serialized_start=3734
  _FIELDCONDITION._serialized_end=3823
  _MATCH._serialized_start=3825
  _MATCH._serialized_end=3920
  _RANGE._serialized_start=3922
  _RANGE._serialized_end=4029
  _WITHPAYLOADSELECTOR._serialized_start=4032
  _WITHPAYLOADSELECTOR._serialized_end=4193
  _PAYLOADINCLUDESELECTOR._serialized_start=4195
  _PAYLOADINCLUDESELECTOR._serialized_end=4235
  _PAYLOADEXCLUDESELECTOR._serialized_start=4237
  _PAYLOADEXCLUDESELECTOR._serialized_end=4277
  _WITHVECTORSSELECTOR._serialized_start=4279
  _WITHVECTORSSELECTOR._serialized_end=4382
  _VECTORSSELECTOR._serialized_start=4384
  _VECTORSSELECTOR._serialized_end=4416
  _SEARCHPOINTS._serialized_start=4419
  _SEARCHPOINTS._serialized_end=4775
  _SCOREDPOINT._serialized_start=4778
  _SCOREDPOINT._serialized_end=5023
  _SCOREDPOINT_PAYLOADENTRY._serialized_start=2445
  _SCOREDPOINT_PAYLOADENTRY._serialized_end=2506
  _SEARCHRESPONSE._serialized_start=5025
  _SEARCHRESPONSE._serialized_end=5092
  _GETPOINTS._serialized_start=5095
  _GETPOINTS._serialized_end=5291
  _RETRIEVEDPOINT._serialized_start=5294
  _RETRIEVEDPOINT._serialized_end=5513
  _RETRIEVEDPOINT_PAYLOADENTRY._serialized_start=2445
  _RETRIEVEDPOINT_PAYLOADENTRY._serialized_end=2506
  _GETRESPONSE._serialized_start=5515
  _GETRESPONSE._serialized_end=5582
  _SCROLLPOINTS._serialized_start=5585
  _SCROLLPOINTS._serialized_end=5865
  _SCROLLRESPONSE._serialized_start=5868
  _SCROLLRESPONSE._serialized_end=6007
  _COUNTPOINTS._serialized_start=6009
  _COUNTPOINTS._serialized_end=6109
  _COUNTRESULT._serialized_start=6111
  _COUNTRESULT._serialized_end=6139
  _COUNTRESPONSE._serialized_start=6141
  _COUNTRESPONSE._serialized_end=6207
  _CREATEALIAS._serialized_start=6209
  _CREATEALIAS._serialized_end=6267
  _RENAMEALIAS._serialized_start=6269
  _RENAMEALIAS._serialized_end=6330
  _DELETEALIAS._serialized_start=6332
  _DELETEALIAS._serialized_end=6365
  _ALIASOPERATIONS._serialized_start=6368
  _ALIASOPERATIONS._serialized_end=6530
  _CHANGEALIASES._serialized_start=6532
  _CHANGEALIASES._serialized_end=6623
  _LISTCOLLECTIONALIASESREQUEST._serialized_start=6625
  _LISTCOLLECTIONALIASESREQUEST._serialized_end=6680
  _LISTALIASESREQUEST._serialized_start=6682
  _LISTALIASESREQUEST._serialized_end=6702
  _ALIASDESCRIPTION._serialized_start=6704
  _ALIASDESCRIPTION._serialized_end=6767
  _LISTALIASESRESPONSE._serialized_start=6769
  _LISTALIASESRESPONSE._serialized_end=6847
  _CREATEFULLSNAPSHOTREQUEST._serialized_start=6849
  _CREATEFULLSNAPSHOTREQUEST._serialized_end=6876
  _LISTFULLSNAPSHOTSREQUEST._serialized_start=6878
  _LISTFULLSNAPSHOTSREQUEST._serialized_end=6904
  _DELETEFULLSNAPSHOTREQUEST._serialized_start=6906
  _DELETEFULLSNAPSHOTREQUEST._serialized_end=6956
  _CREATESNAPSHOTREQUEST._serialized_start=6958
  _CREATESNAPSHOTREQUEST._serialized_end=7006
  _LISTSNAPSHOTSREQUEST._serialized_start=7008
  _LISTSNAPSHOTSREQUEST._serialized_end=7055
  _DELETESNAPSHOTREQUEST._serialized_start=7057
  _DELETESNAPSHOTREQUEST._serialized_end=7128
  _SNAPSHOTDESCRIPTION._serialized_start=7130
  _SNAPSHOTDESCRIPTION._serialized_end=7202
  _CREATESNAPSHOTRESPONSE._serialized_start=7204
  _CREATESNAPSHOTRESPONSE._serialized_end=7301
  _LISTSNAPSHOTSRESPONSE._serialized_start=7303
  _LISTSNAPSHOTSRESPONSE._serialized_end=7400
  _DELETESNAPSHOTRESPONSE._serialized_start=7402
  _DELETESNAPSHOTRESPONSE._serialized_end=7440
  _COLLECTIONS._serialized_start=7763
  _COLLECTIONS._serialized_end=8399
  _POINTS._serialized_start=8402
  _POINTS._serialized_end=8752
  _SNAPSHOTS._serialized_start=8755
  _SNAPSHOTS._serialized_end=9220
# @@protoc_insertion_point(module_scope)
